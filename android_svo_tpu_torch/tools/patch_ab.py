"""The kernels of `csrc/patch_kernels.cu` built from several versions of
that file, checked against each other bit for bit and timed in turns on one
card, so that two versions are compared inside one run:

    python -m android_svo_tpu_torch.tools.patch_ab \\
        [--source NAME=FILE.cu ...] [--patch NAME=FILE.patch ...] \\
        [--only PREFIX ...]

"this" is the checkout's `csrc/patch_kernels.cu`; each `--source` is another
version of that file (a parent commit's, say), each `--patch` this source
with a unified diff applied.  Every version is compiled alone with the
port's nvcc flags into a library of its own under `build/patch_ab/` (all at
once), and the port's own wrappers launch it (the tool points
`cuda_build`'s loaded library at it), so every version is called with the
same arguments.  The reference is the version named `parent`, else the
first `--source`, else this.  A version without the ICLK residency query
(`iclk_residency`, older sources) gets one appended for its own layout, one
warp per feature in blocks of 128 threads.

Problems: the kernel gate's, at its single shapes (768 rows on the 640x480
gate frame, `silicon_gate.gate_inputs`) and batched at B=11 (11 frames of
768 rows at 752x480, `batched_gate_inputs`): the sampler's 4x4 sparse-
alignment form, the same with gradients (sparse alignment's reference
patches), its 8x8 `align1d` form and the gate's 8x8 gradient form; the scan
on the gate's segments (2-99 steps over 70 px) and on the same segments at
the tracking path's spacing (`path_steps`: ops/matcher.py's step count,
0.7 px); the two ICLK kernels (`align_iclk_kernel`,
`align_iclk_window_kernel` with both appearance gates and `/ungated`, 10
iterations).  The ICLK forms also run on a sweep of the batched problem's
rows (`SWEEP`: 768, 1,536, 3,072, 4,224 and 8,448 rows), where each
version's layout, registers, spills, resident blocks per SM and waves are
printed (`iclk_residency`), with the ICLK updates per live feature of the
B=11 problem (`count_iclk_updates`).  Every form of every version is held
against the reference bit for bit (NaN where it has NaN), with the largest
difference reported where they differ, and timed by profiler device time in
the versions' order and back (this, a, b, b, a, this) beside the card's
one-launch floor, the device time of `x8 + 1.0`.  `--only` keeps the forms
whose name starts with one of the prefixes.  Then the host time of the
batched 4x4 sampler and of the two batched ICLK wrappers is split into its
parts (`wrapper_split`, `iclk_wrapper_split`).  Every line carries the
card's name and power limit; the last line is the results as one JSON
object.  CUDA only.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import torch

from android_svo_tpu_torch.ops import cuda_build, silicon_gate
from android_svo_tpu_torch.ops import patch_kernels as pk
from android_svo_tpu_torch.tools import microbench_gather
from android_svo_tpu_torch.tools.probe_ab import apply_patch, build_versions
from android_svo_tpu_torch.utils.profiling import device_ms

OUT_DIR = cuda_build.BUILD_DIR.parent / "patch_ab"
PATH_SPACING = 0.7          # ops/matcher.py: n_steps = epi_len / 0.7 + 1
BATCH = 11                  # the batched step's frames (11 sequences)
GATE_FORMS = ("sample_patches_kernel", "sample_patches_kernel/align1d",
              "sample_patches_kernel/grad", "epi_scan_kernel",
              "align_iclk_kernel", "align_iclk_window_kernel",
              "align_iclk_window_kernel/ungated")
ICLK_FORMS = GATE_FORMS[4:]
# the ICLK row sweep: (frames, rows per frame) of the B=11 problem
SWEEP = ((1, 768), (2, 768), (4, 768), (11, 384), (11, 768))
LAUNCHERS = ["launch_sample_patches", "launch_epi_scan", "launch_align_iclk",
             "launch_align_iclk_window"]
# the residency query for a source older than it: its ICLK layout, one warp
# per feature (K = ceil(area / 32) pixels a lane) in blocks of 128 threads
RESIDENCY_SHIM = r"""
extern "C" int iclk_residency(int half, int window, int n, int* out) {
  void (*k)(IclkArgs) = nullptr;
  switch ((4 * half * half + 31) / 32) {
    case 1: k = window ? &align_iclk_window_kernel<1> : &align_iclk_kernel<1>;
            break;
    case 2: k = window ? &align_iclk_window_kernel<2> : &align_iclk_kernel<2>;
            break;
    case 3: k = window ? &align_iclk_window_kernel<3> : &align_iclk_kernel<3>;
            break;
    case 4: k = window ? &align_iclk_window_kernel<4> : &align_iclk_kernel<4>;
            break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  int blocks = 0, dev = 0, sms = 0;
  cudaError_t rc = cudaFuncGetAttributes(&attr, k);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, 128, 0);
  }
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int vals[7] = {attr.numRegs, (int)attr.localSizeBytes, blocks, 128,
                       (int)blocks_for((long long)n * 32, 128), 1, sms};
  for (int j = 0; j < 7; ++j) out[j] = rc == cudaSuccess ? vals[j] : 0;
  return (int)rc;
}
"""


def path_steps(uv_a, uv_b):
    """The scan's step count at the tracking path's spacing for segments
    uv_a -> uv_b: clamp(int(|b - a| / 0.7) + 1, 2, 100), as
    ops/matcher.py derives it from the segment's length."""
    d = torch.linalg.norm(uv_b - uv_a, dim=-1)
    return torch.clamp((d / PATH_SPACING).to(torch.int32) + 1, 2,
                       100).to(torch.int32)


def mean_spacing(uv_a, uv_b, n_steps) -> float:
    """Mean distance in level pixels between consecutive scan positions."""
    d = torch.linalg.norm(uv_b - uv_a, dim=-1)
    return float((d / torch.clamp(n_steps - 1, min=1)).mean())


def extra_calls(x: dict, batched: bool = False) -> dict:
    """fn(use_pallas) for the two forms the gate's own calls leave out, on a
    gate problem (single, or batched: `batched_gate_inputs`' stacked one):
    `sample_patches_kernel/ref_grad`, the 4x4 sampler with gradients on the
    level-2 substack (sparse alignment's reference patches, once per level
    and frame), and `epi_scan_kernel/path`, the gate's scan segments at the
    path's spacing (`path_steps` positions each)."""
    steps = path_steps(x["uv_a"], x["uv_b"])
    sample = pk.sample_patches_batched if batched else pk.sample_patches
    scan = pk.epi_scan_batched if batched else pk.epi_scan
    return {
        "sample_patches_kernel/ref_grad": lambda up: sample(
            x["sub"], x["zeros_lvl"], x["sub_uv"], 2, grad=True,
            valid=x["valid"], use_pallas=up),
        "epi_scan_kernel/path": lambda up: scan(
            x["stack"], x["lvl"], x["uv_a"], x["uv_b"], x["ref"], 100,
            half=4, n_steps_each=steps, h=x["h"], w=x["w"], use_pallas=up),
    }


def form_calls(x: dict, batched: bool) -> dict:
    """Every form this tool holds and times -> fn(use_pallas), on a gate
    problem (single or batched)."""
    calls = (silicon_gate.batched_kernel_calls(x) if batched
             else silicon_gate.gate_calls(x))
    out = {name: calls[name] for name in GATE_FORMS}
    out.update(extra_calls(x, batched))
    return out


def sweep_problem(xb: dict, frames: int, rows: int) -> dict:
    """The first `rows` features of the first `frames` frames of a batched
    gate problem, each input made contiguous (so the wrappers read it in
    place)."""
    out = {k: (v[:frames, :rows].contiguous() if torch.is_tensor(v)
               and v.dim() >= 2 and k not in ("stack", "sub") else v)
           for k, v in xb.items()}
    out["stack"] = xb["stack"][:frames]
    out["sub"] = xb["sub"][:frames]
    return out


def sweep_calls(xb: dict) -> dict:
    """{f"rows{n}": {ICLK form: fn(use_pallas)}} over `SWEEP`."""
    out = {}
    for frames, rows in SWEEP:
        calls = silicon_gate.batched_kernel_calls(
            sweep_problem(xb, frames, rows))
        out[f"rows{frames * rows}"] = {f: calls[f] for f in ICLK_FORMS}
    return out


def residency(libs: dict, log, label: str) -> dict:
    """Each version's ICLK layout and residency (half 4, both kernels) at
    every row count of the sweep."""
    res = {}
    for name, lib in libs.items():
        for window in (False, True):
            kernel = ("align_iclk_window_kernel" if window
                      else "align_iclk_kernel")
            for frames, rows in SWEEP:
                n = frames * rows
                r = pk.iclk_residency(4, window, n, lib=lib)
                res[f"{name} {kernel} rows{n}"] = r
                log(f"residency {name} {kernel} at {n} rows: "
                    f"{r['registers']} registers, {r['local_bytes']} local "
                    f"bytes, {r['blocks_per_sm']} blocks of "
                    f"{r['threads_per_block']} per SM, {r['blocks']} blocks, "
                    f"{r['features_per_warp']} features a warp, "
                    f"{r['waves']:.2f} waves on {r['sms']} SMs [{label}]")
    return res


def iclk_updates(xb: dict, log, label: str) -> dict:
    """ICLK updates per live feature of the batched problem (the plain
    version's count: features x iterations before each feature stops)."""
    stack, lvl = xb["stack"], xb["lvl"]
    B, N = lvl.shape
    planes, plane = pk._planes(stack, lvl, wrap=False)
    args = [xb[k].reshape((B * N,) + tuple(xb[k].shape[2:]))
            for k in ("ref", "rdx", "rdy", "init", "valid")]
    live = int(xb["valid"].sum())
    res = {}
    for window in (False, True):
        n_upd = pk.count_iclk_updates(
            planes, lvl.reshape(B * N), *args, 10, xb["h"], xb["w"], window,
            plane=plane, L=stack.shape[1])
        key = "align_iclk_window_kernel" if window else "align_iclk_kernel"
        res[key] = n_upd / live
        log(f"ICLK updates {key}, B={B}: {n_upd} over {live} live features, "
            f"{n_upd / live:.3f} per feature [{label}]")
    return res


REPORTS: dict = {}          # version -> ptxas summary of its last build


def ptxas_summary(report: str) -> list:
    """(entry, registers and shared memory) of the sampler's, the scan's
    and the ICLKs' entries in an `nvcc -Xptxas -v` report."""
    out, entry = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "registers" in line and re.search(
                r"sample_patches_kernel|epi_scan_kernel|align_iclk", entry):
            out.append((entry, line.split(":", 1)[-1].strip()))
            entry = None
    return out


def build_all(versions: dict) -> dict:
    """{name: source text} -> {name: loaded library}, one nvcc per version,
    all started together (`probe_ab.build_versions`)."""
    versions = {name: text if "iclk_residency" in text
                else text + RESIDENCY_SHIM for name, text in versions.items()}
    built = build_versions(versions, OUT_DIR,
                           LAUNCHERS + list(cuda_build._QUERIES))
    for name, (_, report) in built.items():
        REPORTS[name] = ptxas_summary(report)
    return {name: lib for name, (lib, _) in built.items()}


def _outputs(out) -> tuple:
    return tuple(out) if isinstance(out, tuple) else (out,)


def _max_diff(a: tuple, b: tuple) -> float:
    d = 0.0
    for u, v in zip(a, b):
        both = torch.isfinite(u) & torch.isfinite(v)
        if both.any():
            d = max(d, float((u[both].double() - v[both].double()).abs()
                             .max()))
    return d


def _device_ms(fn, kernel: str):
    """device_ms, asked again when the profiler lost the kernel's record."""
    for _ in range(3):
        ms = device_ms(fn, kernel, iters=50)
        if ms is not None:
            return ms
    return None


def compare(libs: dict, ref: str, problems: dict, log, label: str) -> dict:
    """Every form of every version against the reference, bit for bit."""
    res = {}
    for pname, calls in problems.items():
        for form, fn in calls.items():
            outs = {}
            for name, lib in libs.items():
                cuda_build._lib = lib
                outs[name] = _outputs(fn(True))
            torch.cuda.synchronize()
            row = {}
            for name, out in outs.items():
                same = all(silicon_gate.same_bits(a, b)
                           for a, b in zip(out, outs[ref]))
                row[name] = {"bit_exact": same,
                             "max_abs_diff": _max_diff(out, outs[ref])}
            res[f"{pname} {form}"] = row
            log(f"{pname} {form}: vs {ref} " + ", ".join(
                f"{n} {'bit-exact' if r['bit_exact'] else 'DIFFERS'}"
                + ("" if r["bit_exact"]
                   else f" (max |d| {r['max_abs_diff']})")
                for n, r in row.items()) + f" [{label}]")
    return res


def time_turns(libs: dict, problems: dict, log, label: str) -> dict:
    """Device ms of every form, the versions in order and back."""
    order = list(libs) + list(libs)[::-1]
    res = {}
    for pname, calls in problems.items():
        for form, fn in calls.items():
            kernel = silicon_gate.kernel_of(form)
            times = {name: [] for name in libs}
            for name in order:
                cuda_build._lib = libs[name]
                times[name].append(_device_ms(lambda: fn(True), kernel))
            res[f"{pname} {form}"] = times
            log(f"{pname} {form}: device ms " + ", ".join(
                f"{k} {v}" for k, v in times.items()) + f" [{label}]")
    return res


def _host_us(fn, iters: int = 2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def wrapper_split(xb: dict) -> dict:
    """Host microseconds per call of the batched 4x4 sampler (the batched
    step's call, B x 768 rows) and of each part of it: the checks, the output
    allocation, the stack's arguments, the stream, the data pointers, the
    ctypes call alone (with n = 0 the launcher returns at once) and with
    its launch, and the views the earlier wrapper made (three flattening
    reshapes and the output's view; the gradient form's unbind).  Taken
    before any profiler session: after one, every launch costs the host
    more."""
    from android_svo_tpu_torch.ops.cuda_build import check, contiguous
    stack, lvl, uv, valid = (xb["sub"], xb["zeros_lvl"], xb["sub_uv"],
                             xb["valid"])
    B, N = lvl.shape
    dev = stack.get_device()
    out = torch.empty((B, N, 4, 4), dtype=torch.float32, device=stack.device)
    grad3 = torch.empty((3, B, N, 4, 4), device=stack.device)
    args = pk._stack_args(stack)
    fn = cuda_build.library().launch_sample_patches
    s = cuda_build.stream(dev)

    def checks():
        check(lvl, "lvl", torch.int32, (B, N), dev)
        contiguous(lvl, "lvl")
        check(uv, "uv", torch.float32, (B, N, 2), dev)
        uv.stride()
        check(valid, "valid", torch.bool, (B, N), dev)
        contiguous(valid, "valid")

    parts = {
        "call": lambda: pk.sample_patches_batched(stack, lvl, uv, 2,
                                                  valid=valid),
        "_sample_kernel": lambda: pk._sample_kernel(stack, lvl, uv, 2,
                                                    False, valid),
        "checks": checks,
        "torch.empty": lambda: torch.empty((B, N, 4, 4), dtype=torch.float32,
                                           device=stack.device),
        "_stack_args": lambda: pk._stack_args(stack),
        "stream": lambda: cuda_build.stream(dev),
        "data_ptr x4": lambda: (lvl.data_ptr(), uv.data_ptr(),
                                valid.data_ptr(), out.data_ptr()),
        "ctypes call (n=0)": lambda: fn(*args, lvl.data_ptr(), uv.data_ptr(),
                                        2, 1, valid.data_ptr(), 0, N, 2, 0,
                                        out.data_ptr(), s),
        "ctypes call and launch": lambda: fn(
            *args, lvl.data_ptr(), uv.data_ptr(), 2, 1, valid.data_ptr(),
            B * N, N, 2, 0, out.data_ptr(), s),
        "earlier views (3 reshapes, 1 view)": lambda: (
            lvl.reshape(B * N), uv.reshape(B * N, 2), valid.reshape(B * N),
            out.view(B, N, 4, 4)),
        "unbind (gradient form)": lambda: grad3.unbind(0),
    }
    return {name: _host_us(f) for name, f in parts.items()}


def iclk_wrapper_split(xb: dict) -> dict:
    """Host microseconds per call of the two batched ICLK wrappers (the
    batched step's calls, B x 768 rows, 10 iterations) and of the parts of one: the
    kernel wrapper alone (`_align_kernel`: the checks, three allocations,
    the arguments and the launch), three output allocations, the stack's
    arguments, the stream, the ctypes call alone (n = 0: the launcher
    returns at once) and with its launch, and the views the earlier wrapper
    made (five flattening reshapes, the level's, three output views).
    Taken before any profiler session, as `wrapper_split`."""
    stack, lvl = xb["stack"], xb["lvl"]
    B, N = lvl.shape
    dev = stack.get_device()
    feats = [xb[k] for k in ("ref", "rdx", "rdy", "init", "valid")]
    h, w = xb["h"], xb["w"]
    outs = [torch.empty((B, N, 2), device=stack.device),
            torch.empty((B, N), dtype=torch.bool, device=stack.device),
            torch.empty((B, N), device=stack.device)]
    fn = cuda_build.library().launch_align_iclk
    s = cuda_build.stream(dev)
    args = pk._stack_args(stack)
    ptrs = [t.data_ptr() for t in feats]
    p = xb["ref"].shape[-1]

    def launcher(n):
        return fn(*args, h, w, N, lvl.data_ptr(), ptrs[0], p * p, p, ptrs[1],
                  p * p, p, ptrs[2], p * p, p, ptrs[3], 2, 1, ptrs[4], n, 10,
                  p // 2, *(o.data_ptr() for o in outs), s)

    parts = {
        "call align_iclk_batched": lambda: pk.align_iclk_batched(
            stack, lvl, *feats, 10, h=h, w=w),
        "call align_iclk_mxu_batched (gated)": lambda: (
            pk.align_iclk_mxu_batched(stack, lvl, *feats, 10, h=h, w=w,
                                      zmssd_factor=2000.0,
                                      min_patch_std=5.0)),
        "_align_kernel": lambda: pk._align_kernel(stack, lvl, *feats[:4],
                                                  feats[4], 10, h, w),
        "torch.empty x3": lambda: (
            torch.empty((B, N, 2), device=stack.device),
            torch.empty((B, N), dtype=torch.bool, device=stack.device),
            torch.empty((B, N), device=stack.device)),
        "_stack_args": lambda: pk._stack_args(stack),
        "stream": lambda: cuda_build.stream(dev),
        "ctypes call (n=0)": lambda: launcher(0),
        "ctypes call and launch": lambda: launcher(B * N),
        "earlier views (6 reshapes, 3 views)": lambda: (
            pk._flat_features(B, N, *feats), lvl.reshape(B * N),
            outs[0].view(B, N, 2), outs[1].view(B, N), outs[2].view(B, N)),
    }
    return {name: _host_us(f) for name, f in parts.items()}


def _keep(calls: dict, only) -> dict:
    return {k: v for k, v in calls.items()
            if not only or k.startswith(tuple(only))}


def run(versions: dict, log=print, only=()) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("patch_ab times kernels on a CUDA card and none "
                           "is available")
    label = microbench_gather.card_label()
    libs = build_all(versions)
    for name, entries in REPORTS.items():
        for entry, usage in entries:
            log(f"ptxas {name}: {entry}: {usage}")
    ref = ("parent" if "parent" in libs else
           next((n for n in libs if n != "this"), "this"))
    dev = torch.device("cuda")
    x = silicon_gate.gate_inputs(n=768, h=480, w=640, seed=0, device=dev)
    frames, xb = silicon_gate.batched_gate_inputs(BATCH, n=768, h=480,
                                                  w=752, seed=0, device=dev)
    del frames
    problems = {"single": _keep(form_calls(x, False), only),
                f"batched_b{BATCH}": _keep(form_calls(xb, True), only)}
    for pname, calls in sweep_calls(xb).items():
        calls = _keep(calls, only)
        if calls and pname != f"rows{BATCH * 768}":   # that one is batched
            problems[pname] = calls
    spacing = {
        "single": {"gate": mean_spacing(x["uv_a"], x["uv_b"], x["nsteps"]),
                   "path": mean_spacing(x["uv_a"], x["uv_b"],
                                        path_steps(x["uv_a"], x["uv_b"]))},
        f"batched_b{BATCH}": {
            "gate": mean_spacing(xb["uv_a"], xb["uv_b"], xb["nsteps"]),
            "path": mean_spacing(xb["uv_a"], xb["uv_b"],
                                 path_steps(xb["uv_a"], xb["uv_b"]))}}
    log(f"scan spacing, mean level px between positions: "
        f"{json.dumps(spacing)} [{label}]")
    res = {"card": label, "reference": ref, "versions": list(libs),
           "spacing": spacing}
    # the host split first: a profiler session leaves every later launch
    # slower on the host
    cuda_build._lib = libs["this"]
    res["wrapper_split_us"] = wrapper_split(xb)
    log(f"batched 4x4 sampler, host us per call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res["wrapper_split_us"].items())
        + f" [{label}]")
    res["iclk_wrapper_split_us"] = iclk_wrapper_split(xb)
    log(f"batched ICLK wrappers, host us per call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res["iclk_wrapper_split_us"].items())
        + f" [{label}]")
    res["residency"] = residency(libs, log, label)
    res["iclk_updates_per_feature"] = iclk_updates(xb, log, label)
    res["compare"] = compare(libs, ref, problems, log, label)
    x8 = torch.zeros((8,), device=dev)
    res["floor_ms"] = device_ms(lambda: x8 + 1.0, "elementwise_kernel",
                                iters=50)
    log(f"one-launch floor (device time of x8 + 1.0): {res['floor_ms']} ms "
        f"[{label}]")
    res["device_ms"] = time_turns(libs, problems, log, label)
    return res


def _pairs(items):
    return dict(item.split("=", 1) for item in items)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=FILE.cu: another version of the source")
    ap.add_argument("--patch", action="append", default=[],
                    help="NAME=FILE.patch: this source with a diff applied")
    ap.add_argument("--only", action="append", default=[],
                    help="PREFIX: only the forms whose name starts with it")
    args = ap.parse_args(argv)
    this = (cuda_build.CSRC / "patch_kernels.cu").read_text()
    versions = {"this": this}
    versions.update({k: Path(v).read_text()
                     for k, v in _pairs(args.source).items()})
    versions.update({k: apply_patch(this, Path(v).read_text())
                     for k, v in _pairs(args.patch).items()})
    print(json.dumps({"patch_ab": run(versions, only=args.only)}),
          flush=True)


if __name__ == "__main__":
    main()
