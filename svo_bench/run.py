"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 -m svo_bench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1> [--control <0|1|2>]

Set-up makes the cell's inputs from the seed, builds the program's state
and warms every shape the window uses; the window then drives the program
for `--seconds` seconds.  `--trace 1` profiles a stretch at the start of
the window and reports the cell's per-layer metrics; `--trace 0` reports
its end-to-end metrics.  After the window the check (`check.py`) decides
`correct`.  The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.

`--control 1` also reads the lower-precision control on the same calls,
`--control 2` runs the control in the patch functions' place for the whole
run: both are for setting the limits, and the benchmark's own runs use
neither.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and 3
if JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "android_svo_tpu")


def process_age_s() -> float:
    """Seconds since this process started (/proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sample_units(seed: int, n: int, span: int) -> set:
    """The units whose patch calls and stacks the check keeps: n of the
    first `span`, drawn from the seed."""
    return set(random.Random(f"check-{seed}").sample(range(span),
                                                      min(n, span)))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def program_shaped(kind: str, a: dict, out):
    """The reference's outputs in the program's shapes and dtypes."""
    import torch
    rows = tuple(a["lvl"].shape)
    if kind == "sample_patches":
        p = 2 * int(a["half"])
        outs = out if isinstance(out, tuple) else (out,)
        outs = tuple(o.to(torch.float32).reshape(rows + (p, p)) for o in outs)
        return outs if a["grad"] else outs[0]
    if kind == "epi_scan":
        return tuple(o.to(torch.float32).reshape(rows) for o in out)
    uv, conv, mean = out
    return (uv.to(torch.float32).reshape(rows + (2,)), conv.reshape(rows),
            mean.to(torch.float32).reshape(rows))


def alter_kernel(kind, a, call):
    """A planted fault: every seventh row of the patch functions' answers
    altered where they are produced."""
    out = call()
    if kind == "sample_patches":
        outs = out if isinstance(out, tuple) else (out,)
        for o in outs:
            o.view(-1, *o.shape[o.dim() - 2:])[::7] += 2.0
        return out
    if kind == "epi_scan":
        t, s = out
        return t.reshape(-1).roll(1).reshape(t.shape), s
    uv, conv, mean = out
    uv = uv.clone()
    uv.view(-1, 2)[::7] += 0.5
    return uv, conv, mean


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device=None, control: int = 0, faults: tuple = (),
            min_units: int = 0, root=None, log=_log) -> dict:
    """Set up, warm, run the window and check one cell; the result line as
    a dict.  `device` (default CUDA), `faults` (planted in the timed path)
    and `min_units` (the window's least units) serve the benchmark's own
    tests; `root` is the checkout whose BENCHMARK.json names the cell."""
    import torch

    from svo_bench import cells, check, drivers, probe
    from svo_bench import trace as tr
    from svo_bench.reference import bounds

    where = () if root is None else (root,)
    cell = cells.find_cell(workload, *where)
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    traffic = cell.traffic
    Driver = drivers.DRIVERS[traffic["driver"]]
    driver = Driver(cell.config, traffic, seed, dev, seconds)
    driver.warm()
    if on_card:
        torch.cuda.synchronize()
    pr = probe.PatchProbe(driver.pk, Driver is drivers.BatchedDriver)
    pr.install()
    pp = probe.PoseProbe(driver.pipeline).install()
    if control == 2:
        pr.replace = lambda kind, a, call: program_shaped(
            kind, a, check.reference_call(kind, a, check.CONTROL))
    for fault in faults:
        if fault == "altered_kernel":
            pr.replace = alter_kernel
        else:
            driver.break_step(fault)
    chk, st = traffic["check"], traffic["trace"]
    sampled = sample_units(seed, chk["units"], chk["span"])
    # the window closes no earlier than the last unit the check samples
    min_units = max(min_units, max(sampled) + 1)
    pose_units = int(chk["pose_units"])

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = dict(driver.pk.LAUNCHES)
    wait0 = driver.feeder_wait_s()
    prof = stopped = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))
        prof.__enter__()
        pr.ranges = True
        driver.set_perf_mon(True)
        ba0 = driver.local_ba_runs()
    units, stacks, stretch_kf = [], [], []
    # no collector pauses inside the window: what set-up made is frozen
    # out of the collector's reach, and the window's garbage is freed by
    # reference counts
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.2f} s")
    t_start = time.perf_counter()
    while True:
        pr.capture = len(units) in sampled
        pp.capture = len(units) < pose_units
        t0 = time.perf_counter()
        u = driver.unit(prof is not None)
        t1 = time.perf_counter()
        u["seconds"] = t1 - t0
        units.append(u)
        if pr.capture:
            stacks.append(driver.stacks())
        if prof is not None:
            stretch_kf.append(u["keyframe"])
            n = len(stretch_kf)
            if n >= st["max_units"] or (
                    n >= st["min_units"]
                    and stretch_kf.count(False) >= st.get("min_plain", 0)
                    and stretch_kf.count(True) >= st.get("keyframes", 0)
                    and driver.local_ba_runs() - ba0 >= st.get("local_ba", 0)):
                prof.__exit__(None, None, None)
                pr.ranges = False
                driver.set_perf_mon(False)
                stopped, prof = prof, None
        if t1 - t_start >= seconds and len(units) >= min_units and (
                prof is None):
            break
    window_s = t1 - t_start
    gc.enable()
    pr.capture = pp.capture = False
    pr.remove()
    pp.remove()
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launches = {n: v - launches0[n] for n, v in driver.pk.LAUNCHES.items()}
    wait = driver.feeder_wait_s()
    driver.close()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded once the window closed: {found}")

    # ---- the check ---------------------------------------------------------
    t_check = time.perf_counter()
    n_seq = driver.units_per_step
    est = [[] for _ in range(n_seq)]
    gt = [[] for _ in range(n_seq)]
    for u in units:
        for s, (g, pose, ok) in enumerate(zip(u["g"], u["pose"], u["ok"])):
            if ok:
                est[s].append(pose[7:10])
                gt[s].append(driver.position(g, s))
    poses = [check.pose_numbers(e, g) for e, g in zip(est, gt)]
    failed = sum(not ok for u in units for ok in u["ok"])
    numbers = {"failures": failed,
               "ate_m": max(p["ate_m"] for p in poses),
               "stack_gap": max((check.stack_gap(*sf) for sf in stacks),
                                default=float("nan")),
               **check.kernel_numbers(pr.calls)}
    gaps = check.pose_gaps(pp.calls)
    numbers["pose_gap_px"] = check.rms(gaps)
    top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:3]
    kf = [i for i, u in enumerate(units) if u["keyframe"]]
    log(f"window: {len(units)} {Driver.unit_name}s in {window_s:.3f} s, "
        f"keyframes at {kf}, local BA runs {driver.local_ba_runs()}")
    for s, p in enumerate(poses):
        log(f"sequence {s}: window ATE {p['window_ate_m']:.6f} m; "
            f"{check.STRETCH}-frame stretches: ATE {p['stretch_ate_m']}, "
            f"Sim(3) scale {p['stretch_scale']}")
    log(f"{len(pr.calls)} patch calls checked on {len(stacks)} "
        f"{Driver.unit_name}s, {len(pp.calls)} pose refinements (widest "
        f"gaps, px, by refinement: {[(i, gaps[i]) for i in top]}): "
        + json.dumps(numbers))
    if control == 1:
        log("control: " + json.dumps({
            **check.control_numbers(pr.calls, stacks),
            **check.pose_control(pp.calls)}))
    correct, compared = check.decide(numbers, check.load_limits(
        cell.name, cells.bench_dir(*where)))
    log(f"check {time.perf_counter() - t_check:.2f} s")

    # ---- the metrics -------------------------------------------------------
    ctx = {"units": units, "units_per_step": n_seq, "window_s": window_s,
           "setup_s": setup_s, "launches": launches,
           "feeder_wait_s": None if wait is None else wait - wait0,
           "stretch": {}, "stretch_keyframe": stretch_kf}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        t_trace = time.perf_counter()
        stretch = tr.reduce_events(tr.from_profiler(stopped),
                                   f"svo_bench.{Driver.unit_name}")
        ctx["stretch"] = stretch
        seen = {}
        ctx["kernel_calls"] = []
        for kind, a in pr.traced:
            ranges = stretch["ranges"].get(f"svo_bench.{kind}", [])
            i = seen[kind] = seen.get(kind, -1) + 1
            if i < len(ranges):
                ctx["kernel_calls"].append(
                    (bounds.call_seconds(kind, a), ranges[i][1] / 1e6))
        device_info.update(busy_s=stretch.get("busy_s", 0.0),
                           window_s=stretch.get("window_s", 0.0))
        breakdown = {k: [[name[:160], sec] for name, sec in stretch[k]]
                     for k in ("device_ops", "idle_gaps")}
        log(f"profiled stretch: {len(stretch['units'])} "
            f"{Driver.unit_name}s, keyframes {stretch_kf}, device activities "
            f"linked to their launch {stretch.get('linked_share', 0):.3f}, "
            f"reduced in {time.perf_counter() - t_trace:.2f} s")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.load_reader(m["name"], *where)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(units) * n_seq,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1, 2), default=0)
    args = ap.parse_args(argv)
    import torch

    from svo_bench import cells
    chips = cells.find_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"svo_bench: needs {chips} CUDA card(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        return 2
    torch.set_num_threads(1)
    try:
        result = execute(args.workload, args.seed, args.seconds,
                         bool(args.trace), control=args.control)
    except SystemExit as e:
        _log(f"svo_bench: {e}")
        return 3
    for name, c in result["compared"].items():
        _log(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
