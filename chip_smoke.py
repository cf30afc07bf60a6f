#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; the last line is printed only when
every phase passed):
  1. device  — needs torch.cuda; prints the card's name and power limit.
  2. build   — compiles the CUDA patch kernels from csrc/ with nvcc.
  3. gate    — each kernel against its plain PyTorch version on the card at
               the tracking path's shapes (768 features, 640x480 pyramid),
               with the bounds of the JAX package's kernel gate; times each
               kernel, its plain version and (where one exists) a library
               call with CUDA events, and computes its bound.
  4. main    — FrameHandler at 640x480, SVOConfig(init_min_disparity=20,
               max_n_kfs=8, loba_n_iter=0), 40 frames of the bench orbit
               rendered on the card: bootstrap, tracking, keyframes.  Every
               kernel's launch count must grow during this run.
  5. plain   — the same 40 frames with use_pallas=False on the card; the
               launch counts must not move, and the trajectory must agree.
Prints a `{"kernels": [...]}` line and ends with one JSON line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores

KERNEL_META = {
    "sample_patches_kernel": (
        "android_svo_tpu/ops/patch_pallas.py:171 (_sample_pallas)"),
    "epi_scan_kernel": (
        "android_svo_tpu/ops/patch_pallas.py:313 (_scan_pallas)"),
    "align_iclk_kernel": (
        "android_svo_tpu/ops/patch_pallas.py:521 (_align_pallas)"),
    "align_iclk_window_kernel": (
        "android_svo_tpu/ops/patch_pallas.py:692 (_dump_pallas) + "
        "android_svo_tpu/ops/patch_pallas.py:779 (align_iclk_mxu ICLK)"),
}
SOURCE = "android_svo_tpu_torch/csrc/patch_kernels.cu"
N_FRAMES = 40


class CheckFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_time_us(evt) -> float:
    if hasattr(evt, "device_time_total"):
        return float(evt.device_time_total)
    return float(evt.cuda_time_total)


def device_ms(fn, symbol, iters=20):
    """Device time of the kernel alone per launch, from the profiler's CUDA
    activity records; None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if symbol in evt.key:
            total_us += _device_time_us(evt)
            count += evt.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            int(bytes_moved), int(flops))


def kernel_bounds(x, pk):
    """Least time for each kernel's work on this run's inputs: every input
    byte read once (for the image, only the pixels the patches touch, capped
    at the planes' size), every output byte written once, and the fp32
    operations the data needs (bilinear sample ~11 flops/px; the scan and
    ICLK loops counted with this run's step and update counts)."""
    import torch
    n = int(x["lvl"].shape[0])
    h, w = x["h"], x["w"]
    planes = 4 * sum((h >> l) * (w >> l) for l in range(3))
    out = {}
    # sample: 4x4 patches on the level-2 substack (the GN-iteration call)
    sub_bytes = 4 * (h >> 2) * (w >> 2)
    touched = min(n * 5 * 5 * 4, sub_bytes)
    out["sample_patches_kernel"] = bound(
        touched + n * (4 + 8 + 1) + n * 16 * 4, n * 16 * 11)
    # epi_scan: per seed the bounding box of its segment (+ the patch)
    k = torch.clamp(x["nsteps"].long(), 0, 100)
    seg = x["seg"].abs() * 2.0
    box = ((seg[:, 0] + 9) * (seg[:, 1] + 9)).sum().item()
    steps = int(k.sum())
    out["epi_scan_kernel"] = bound(
        min(box * 4, planes) + n * (64 * 4 + 16 + 4 + 4) + n * 8,
        steps * 64 * 15)
    # ICLK: patch footprint with the +-2 px start offset
    foot = min(n * 13 * 13 * 4, planes)
    for name, window in (("align_iclk_kernel", False),
                         ("align_iclk_window_kernel", True)):
        upd = pk.count_iclk_updates(
            x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"],
            x["uv"] + x["off"], x["valid"], 10, h, w, window)
        evals = upd + n                        # + the final probe
        flops = evals * (64 * 19 + 15) + (n * 64 * 8 if window else 0)
        ins = n * (3 * 64 * 4 + 36 + 8 + 1 + 4) + (n * 8 if window else 0)
        outs = n * (4 * 6 if window else 16)
        out[name] = bound(foot + ins + outs, flops)
    return out


def library_sample_ms(x):
    """One PyTorch call computing the sparse-align sampler's function on the
    same inputs: grid_sample (bilinear, border clamp) on the substack."""
    import torch
    import torch.nn.functional as F
    sub = x["sub"]
    _, hs, ws = sub.shape
    offs = torch.arange(4, device=sub.device, dtype=torch.float32) - 2
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    px = x["sub_uv"][:, None, 0] + ox.reshape(1, -1)
    py = x["sub_uv"][:, None, 1] + oy.reshape(1, -1)
    grid = torch.stack([2 * px / (ws - 1) - 1, 2 * py / (hs - 1) - 1], -1)
    img = sub[None].contiguous()
    grid = grid[None]
    return time_ms(lambda: F.grid_sample(img, grid, mode="bilinear",
                                         padding_mode="border",
                                         align_corners=True))


def make_poses(synthetic, n, step, device):
    """A copy of bench.py's make_poses(smoke=False): a 4-frame bootstrap
    pre-roll, then a slow orbit pitched 0.45 rad off fronto-parallel."""
    n_pre = 4
    poses = []
    n_orbit = max(n - n_pre, 1)
    for i in range(min(n_pre, n)):
        k = n_pre - i
        poses.append(synthetic.lookdown_pose(
            -3.0 * step * k, -0.9 * step * k, -3.0, (0.45, 0.0, 0.0),
            device=device))
    for i in range(max(n - n_pre, 0)):
        ph = 2.0 * math.pi * i / n_orbit
        poses.append(synthetic.lookdown_pose(
            25 * step * math.sin(ph), 8 * step * math.cos(ph) - 8 * step,
            -3.0, (0.45 + 0.0008 * i, -0.0008 * i, 0.001 * i),
            device=device))
    return poses


STAGES = ("pyramid_creation", "sparse_img_align", "reproject",
          "pose_optimizer", "point_optimizer", "depth_filter", "keyframe")


def profile_frames(cfg, cam, imgs, device, start, n):
    """torch.profiler over n steady-state tracking frames (after `start`
    frames of warm-up).  Device busy time = summed durations of the device
    activities (kernels, copies; the stage annotations excluded); per stage
    (the track_frame ranges): host wall time, the device time of the work
    launched inside it, and its span on the device timeline; the device
    activities that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from android_svo_tpu_torch.core import frame_handler as fh

    handler = fh.FrameHandler(cam, cfg, device=device)
    for img in imgs[:start]:
        handler.add_image(img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for img in imgs[start:start + n]:
            handler.add_image(img)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    busy_us, n_dev = 0.0, 0
    by_name: dict = {}
    stages = {k: {"host_ms": 0.0, "device_ms": 0.0, "device_span_ms": 0.0}
              for k in STAGES}
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        if e.name in STAGES:
            st = stages[e.name]
            if e.device_type == DeviceType.CUDA:
                st["device_span_ms"] += dur / 1e3 / n
            else:
                st["host_ms"] += dur / 1e3 / n
                st["device_ms"] += _device_time_us(e) / 1e3 / n
        elif e.device_type == DeviceType.CUDA:
            busy_us += dur
            n_dev += 1
            key = e.name[:80]
            tot, cnt = by_name.get(key, (0.0, 0))
            by_name[key] = (tot + dur, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"frames": n, "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_us / 1e3 / n,
            "device_activities_per_frame": n_dev / n, "stages": stages,
            "top_device_ops": [[k, v[0] / 1e3 / n, v[1] / n]
                               for k, v in top]}


def run_sequence(cfg, cam, imgs, poses, device):
    import torch
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.evals.trajectory import ate_rmse

    handler = fh.FrameHandler(cam, cfg, device=device)
    est, gt, track_ms, results = [], [], [], []
    n_fail = n_kf = 0
    for i, img in enumerate(imgs):
        was_default = handler.stage == fh.STAGE_DEFAULT_FRAME
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = handler.add_image(img)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if handler.stage == fh.STAGE_DEFAULT_FRAME:
            t_wc = res.t_wc if res.t_wc is not None else res.T_cw.inverse().t
            est.append(t_wc.detach().cpu().numpy().astype(np.float64))
            gt.append(poses[i].t.detach().cpu().numpy().astype(np.float64))
        if was_default:
            track_ms.append(dt)
            results.append(res.result)
            n_fail += res.result == pipeline.RES_FAILURE
            n_kf += res.result == pipeline.RES_IS_KEYFRAME
    est = np.array(est)
    gt = np.array(gt)
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("inf")
    return {"stage": handler.stage, "n_fail": int(n_fail), "n_kf": int(n_kf),
            "ate": ate, "est": est, "n_tracked_frames": len(track_ms),
            "median_ms": statistics.median(track_ms) if track_ms else None,
            "results": results,
            "n_kf_total": int(handler.vo.kfs.valid.sum())}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import android_svo_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 3

    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.ops import cuda_build, silicon_gate
    from android_svo_tpu_torch.ops import patch_kernels as pk

    dev = torch.device("cuda")
    # ---- 1. device --------------------------------------------------------
    label = card_label()
    kind = torch.cuda.get_device_name(0)
    log(label)                  # nvidia-smi's name,power.limit line
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build(force=True)
    cuda_build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_build.build_info['seconds']:.2f} s)")
    for line in cuda_build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernel gate + timings ---------------------------------------------
    x = silicon_gate.gate_inputs(n=768, h=480, w=640, seed=0, device=dev)
    gate = silicon_gate.run_gate(x)
    torch.cuda.synchronize()
    log("gate: " + json.dumps({k: (round(v, 6) if isinstance(v, float)
                                   else v) for k, v in gate.detail.items()}))
    require(gate.ok, f"kernel gate failed: {gate.failures}")
    calls = silicon_gate.kernel_calls(x)
    bounds = kernel_bounds(x, pk)
    lib_ms = {"sample_patches_kernel": library_sample_ms(x)}
    timing = {}
    for name, fn in calls.items():
        k_ms = time_ms(lambda: fn(True))
        p_ms = time_ms(lambda: fn(False), iters=10, warmup=2)
        try:
            d_ms = device_ms(lambda: fn(True), name)
        except Exception as e:          # the profiler is optional here
            log(f"profiler unavailable for {name}: {e!r}")
            d_ms = None
        timing[name] = (k_ms, p_ms, d_ms)
        log(f"time {name}: wrapper {k_ms:.4f} ms, device "
            f"{'n/a' if d_ms is None else f'{d_ms:.4f}'} ms, plain "
            f"{p_ms:.4f} ms, bound {bounds[name][0]:.5f} ms "
            f"({bounds[name][1]}) [{label}]")

    # ---- 4. main path on the kernels -------------------------------------------
    cfg = SVOConfig(init_min_disparity=20.0, max_n_kfs=8, loba_n_iter=0)
    cam = synthetic.default_camera(640, 480, device=dev)
    tex = synthetic.make_texture(torch.Generator().manual_seed(0), 2048,
                                 device=dev)
    poses = make_poses(synthetic, 148, 0.02, dev)[:N_FRAMES]
    imgs = [synthetic.render(tex, cam, p) for p in poses]
    torch.cuda.synchronize()

    pk.reset_launch_counts()
    run_k = run_sequence(cfg, cam, imgs, poses, dev)
    launches = dict(pk.LAUNCHES)
    log(f"main path [{label}]: stage {run_k['stage']}, tracked frames "
        f"{run_k['n_tracked_frames']}, failures {run_k['n_fail']}, "
        f"keyframes after bootstrap {run_k['n_kf']}, ATE {run_k['ate']:.6f}, "
        f"median {run_k['median_ms']:.2f} ms/frame "
        f"({1e3 / run_k['median_ms']:.2f} fps)")
    log(f"launches on the main path: {json.dumps(launches)}")
    require(run_k["stage"] == 3, "main path did not reach DEFAULT")
    require(run_k["n_fail"] == 0, f"{run_k['n_fail']} tracking failures")
    require(run_k["n_kf"] >= 1, "no keyframe inserted after bootstrap")
    require(math.isfinite(run_k["ate"]) and run_k["ate"] <= 0.02,
            f"ATE {run_k['ate']} > 0.02")
    for name, cnt in launches.items():
        require(cnt > 0, f"{name} was not launched on the main path")

    # ---- 4b. where a tracking frame's time goes (profiled, steady state) --
    prof = profile_frames(cfg, cam, imgs, dev, 30, 6)
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / run_k["median_ms"]
    prof["card"] = label
    print(json.dumps({"profile": prof}), flush=True)

    # ---- 5. reference run on the plain versions --------------------------------
    pk.reset_launch_counts()
    run_p = run_sequence(cfg.replace(use_pallas=False), cam, imgs, poses, dev)
    log(f"plain path [{label}]: stage {run_p['stage']}, failures "
        f"{run_p['n_fail']}, keyframes after bootstrap {run_p['n_kf']}, ATE "
        f"{run_p['ate']:.6f}, median {run_p['median_ms']:.2f} ms/frame")
    require(all(v == 0 for v in pk.LAUNCHES.values()),
            f"plain run launched kernels: {pk.LAUNCHES}")
    require(run_p["n_fail"] == 0, f"plain run: {run_p['n_fail']} failures")
    require(run_p["est"].shape == run_k["est"].shape,
            "plain and kernel runs tracked different frame counts")
    dc = float(np.abs(run_p["est"] - run_k["est"]).max())
    log(f"camera centres, kernel vs plain run: max |d| {dc:.6f}")
    require(dc <= 5e-3, f"camera centres differ by {dc} > 5e-3")
    require(abs(run_p["n_kf"] - run_k["n_kf"]) <= 1,
            f"keyframes {run_k['n_kf']} vs plain {run_p['n_kf']}")

    kernels = []
    for name in ("sample_patches_kernel", "align_iclk_window_kernel",
                 "epi_scan_kernel", "align_iclk_kernel"):
        k_ms, p_ms, d_ms = timing[name]
        b_ms, b_by, b_bytes, b_flops = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": KERNEL_META[name], "launches": launches[name],
            "max_abs_err": gate.max_abs_err.get(name, 0.0), "ms": k_ms,
            "kernel_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": b_bytes, "bound_flops": b_flops,
            "library_ms": lib_ms.get(name), "card": label})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"main_path": {
        "card": label, "ate": run_k["ate"], "ate_plain": run_p["ate"],
        "median_ms": run_k["median_ms"],
        "fps": 1e3 / run_k["median_ms"],
        "median_ms_plain": run_p["median_ms"], "keyframes": run_k["n_kf"],
        "keyframes_plain": run_p["n_kf"], "centre_dev": dc}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
