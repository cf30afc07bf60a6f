#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; the last line is printed only when
every phase passed):
  1. device  — needs torch.cuda; prints the card's name and power limit.
  2. build   — compiles every CUDA source in csrc/ with nvcc (in parallel)
               into one library.
  3. gate    — each patch kernel against its plain PyTorch version on the
               card at the tracking path's shapes (768 features, 640x480
               pyramid), with the bounds of the JAX package's kernel gate,
               in every form the configurations give it (also the 1D
               alignment's 8x8 sampler at mixed levels with a valid mask,
               and the window ICLK with its gates off), and the window dump
               (dump_windows_kernel, 768 windows on the 3-level stack with
               a mixed valid mask and some non-finite centres: valid rows
               bit for bit, origins equal, dead rows zero);
               times each kernel, its plain version and (where one exists) a
               library call with CUDA events (for the dump a 3-D
               grid_sample(mode="nearest") at the windows' pixel centres,
               which must copy the same pixels), and computes its bound; counts
               the ATen ops and device activities one call of each kernel's
               wrapper dispatches (at most 4 for the sampler, 3 for the
               other patch kernels and the dump, 1 for the probe; exactly 1
               device activity).  Two forms the gate's calls leave out are
               held to its bounds and timed too (tools/patch_ab.py): the
               sampler's 4x4 gradient form on the substack (sparse
               alignment's reference patches) and the scan at the tracking
               path's 0.7 px spacing (100 steps a seed), with the mean
               spacing of both scan forms.  The two ICLK kernels' layout
               and residency at 768 and 11 x 768 rows (registers, local
               bytes, resident blocks per SM, waves; iclk_residency): a
               layout that spills fails the phase.
  3b. probe  — probe_patches_kernel variants A-D against their plain version
               (<= 1e-5; the kernel is bit-exact, and the line says whether
               it was) and variant A against interp.extract_patches
               (<= 1e-4), at N=2048 (the reference's size) and N=32768 on
               480x640; the card's one-launch floor (the device time of the
               microbench's trivial op, x8 + 1.0), and at each size variant
               A's kernel time and bound and its wrapper's time against
               grid_sample's (B-D's times at N=2048).
  3c. microbench — the gather microbench (tools/microbench_gather.py), the
               probe kernel's path; its launches are counted.
  3d. pose   — pose_gn_kernel (optimize_pose on the card) against its plain
               version (the same call with use_pallas=False) on the same
               inputs, with the card tests' tolerances
               (silicon_gate.compare_pose: projection gap <= 0.05 px, chi2
               and cov to rounding, inliers equal but within 0.05 px of the
               threshold), at 912 rows (the cells' arena at 752x480) and
               768 (640x480), GN and LM, and through torch.func.vmap on 11
               sequences of 912 rows (each sequence within those
               tolerances of its plain version, bit for bit its single
               launch); one launch per call, one device activity, at most
               7 ATen ops for a frame, no read of the card back; the
               wrapper's time, the kernel's device time, the plain
               version's and the bound (pose_bound), single and batched.
  3e. align  — sparse_align_kernel (sparse_img_align on the card) against
               the plain loop (the same call with use_pallas=False) on the
               same inputs, with the card tests' tolerances
               (silicon_gate.compare_align: projection gap <= 0.05 px at
               level 0, n_tracked equal, chi2 within 1e-4), at EuRoC's
               radtan camera (752x480, 912 rows) and TUM fr3's
               distortion-free one (640x480, 768 rows), GN and LM, and
               batched on 11 frames of 912 rows (each frame within those
               tolerances of its plain loop, bit for bit its single launch,
               iteration counts included); one kernel launch per call
               beside the set-up's samplers, no read of the card back; the
               call's time, the kernel's device time with the iterations
               it ran (read from the device), the plain loop's time and
               the bound (align_bound), single and batched.
  4. main    — FrameHandler at 640x480, SVOConfig(init_min_disparity=20,
               max_n_kfs=8, loba_n_iter=0), 40 frames of the bench orbit
               rendered on the card: bootstrap, tracking, keyframes.  Every
               kernel's launch count must grow during this run.
  4b. profile — torch.profiler over six steady-state frames.
  5. plain   — the same 40 frames with use_pallas=False on the card; the
               launch counts must not move, and the trajectory must agree.
  6. default — FrameHandler at the default configuration with local BA on,
               SVOConfig(init_min_disparity=20, max_n_kfs=8), over the full
               148-frame bench orbit: DEFAULT reached, 0 failures, local BA
               run, every patch kernel launched, ATE <= 0.02; one local BA
               call profiled; then make_track_scan over frames 40-63 from a
               fresh handler's steady state: 0 failures, ATE <= 0.02 with
               the handler's earlier frames, t_wc within 0.02 of the run
               above (which runs local BA between those frames).
  7. reloc   — the relocalization demo (tools/reloc_demo.py): tracking lost
               on blank frames, recovered, final stage DEFAULT, every patch
               kernel launched.
  8. variants — 8a: phase 4's configuration and frames with
               poseoptim_method = structureoptim_method = "lm": DEFAULT,
               0 failures, a keyframe, ATE <= 0.02, every patch kernel
               launched; then on the plain versions: no launch, camera
               centres within 5e-3.  8b: edgelet detection with the 1D
               alignment (EDGE_CFG) on the 20 frames of tests/
               test_edgelet.py's sweep over the edge-rich texture, rendered
               on the card at 640x480: DEFAULT, 0 failures, live edgelet
               landmarks and seeds, ATE <= max(0.02, 2 x JAX_ATE_EDGE),
               the sampler, window ICLK and scan launched and align_iclk
               not (the 1D refinement replaces it); then the plain run as
               in 8a.  Each prints its median frame, its keyframe-frame
               median and its launches per tracked frame; 8b also the
               calls and host time of align1d_stack per frame.
  9. dataset — the dataset path at EuRoC MH_01 cam0's geometry (752x480,
               radtan distortion): (a) the patch kernels' gate at 752x480
               (level 0 padded to 768 columns, level 4 47 wide; the dump
               too); (b) the
               148-frame orbit rendered on the card through that camera,
               quantised to uint8 and written as an ASL tree (stdlib PNGs,
               data.csv at 20 Hz, sensor.yaml, ground truth); (c) load_euroc
               on the card (camera fields as written, on the card),
               yuv420_to_rgb within 1e-3 of a float64 reference, the H2D
               copy of one frame from pinned memory timed; (d)
               FrameHandler at the default configuration over the frames
               the native feeder decodes into pinned memory and copies to
               the card: DEFAULT, 0 failures, local BA run, every patch
               kernel launched, ATE <= 0.02; every frame, kept to the end,
               equal to its uint8 image and its 640x480 Y plane through
               yuv420_to_gray bit-exact; a profile of six steady-state
               frames; (e) checkpoint after frame 100, resume,
               the tail's T_cw.t within 1e-6; (f) the overlay on every 10th
               tracked frame: one PPM per call, the cube's faces drawn
               whenever its corners are in front of the camera.
 10. batched — (in a process of its own, started by this script) the
               batched multi-sequence step and the sharded paths at
               MH_01 cam0's geometry: (a) the four patch kernels' batched
               forms and the window dump's at B=11 (11 frames' 3x480x768
               stacks, 768 features each; the dump on the mixed valid mask
               and partly non-finite centres): within the gate's bounds of
               their batched plain versions (the dump: valid rows bit for
               bit, origins equal, dead rows zero), bit for bit the 11
               single launches, one launch and one device activity per
               call (the two ICLKs at most 3 ATen ops: their (B, N) rows
               read in place); the dump's 3-D grid_sample on the 11 stacks
               timed beside it; phase 3's two extra forms batched, held and
               timed the same way; (b) 11 sequences (their
               own textures, seeds 0-10, and orbits) bootstrapped each in
               its own FrameHandler at the default SVOConfig(), stacked,
               and tracked by make_batched_track for 30 frames: 0
               failures, ATE <= 0.02 per sequence, a step where some but
               not all take a keyframe; the first 10 frames rerun as each
               sequence's single step (camera centres within 1e-4, equal
               result codes, each kernel launched per step as a single step
               is, each sequence's alignment iterations per level its single
               step's); the
               batched plain run (no launch, centres within 5e-3); the
               step's time at B=11 and B=1, the single step's, a profile
               of 3 steps; (c) make_sharded_ba on the card, 2 gloo ranks
               and an NCCL group over every card, P = 2048 and 16384, O=8,
               NC=5: within 1e-5 of local_ba, chi2 within 1e-4, exactly
               loba_n_iter all-reduces of 4,564 bytes; (d)
               make_sharded_track in 2 gloo ranks on the card, (data=2,
               map=1) and (data=1, map=2), and on a host of 2 or more
               cards one NCCL rank per card on their (data, map) mesh,
               4 sequences from a checkpoint of 10b's stacked state, 3
               steps: within 1e-4 of the unsharded batched step, equal
               result codes.
 11. surface — the public names the last slice added, on the card: (a)
               interp.extract_patches_with_grad on one 480x640 level at 768
               centres against sample_patches_kernel's gradient form on a
               one-level stack (<= 0.02 where the patch and one pixel
               around it lie inside); (b) dump_windows at the detector's
               features of the gate frame against its plain version, and
               torch.func.vmap(dump_windows) over 3 frames' stacks (one
               launch, equal to dump_windows_batched) and over one shared
               stack (one launch, each frame equal to its single launch); (c)
               feature_align.align1d on the card against its CPU run
               (converged flags equal, uv within 1e-4, on the 160x120
               level); (d) SE3.from_matrix(as_matrix()) round trip (1e-5);
               (e) rpe_stats of phase 9's trajectory beside its ATE; (f)
               after enable_compilation_cache(), cuda_build.build() returns
               the built library without starting nvcc.  Both kernels must
               launch; each vmap call of the dump is one launch.
Each path (3c, 4, 5, 6, 7, 8a and 8b with their plain runs, 9, 10b and its
plain run, 11) runs with the launch counts set to 0 just before it and read
just after; on a tracking path those of the patch kernels and of
pose_gn_kernel and sparse_align_kernel, all 0 on each plain run.  The
tracking paths (4, 6, 7, 8a, 8b, 9, 10b) launch every patch kernel but
dump_windows_kernel, which only the public dump_windows runs (8b also not
align_iclk_kernel); there its count must stay 0.  They launch
pose_gn_kernel and sparse_align_kernel once a tracked frame (4, 6, 8a, 8b,
9) and once a batched step (10b; 7, which relocalizes, at least once).
Prints a `{"kernels": [...]}` line (all eight kernels; pose_gn's and
sparse_align's with their 768-row and batched forms and their launches per
frame and step)
and ends with one JSON line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
    "dump_windows_kernel": (
        "android_svo_tpu/ops/patch_pallas.py:692 (_dump_pallas) through "
        "android_svo_tpu/ops/patch_pallas.py:720 (dump_windows)"),
    "pose_gn_kernel": (
        "none: the JAX package leaves android_svo_tpu/core/pose_opt.py "
        "(optimize_pose) to XLA"),
    "sparse_align_kernel": (
        "none: the JAX package leaves android_svo_tpu/ops/sparse_align.py "
        "(sparse_img_align's while-loop) to XLA"),
}
# the README's slice of the port that made each kernel what it is now
REDESIGNED_IN = {"sample_patches_kernel": "slice 11",
                 "align_iclk_window_kernel": "slice 3, 12",
                 "align_iclk_kernel": "slice 4, 12",
                 "epi_scan_kernel": "slice 11",
                 "probe_patches_kernel": "slice 5",
                 "dump_windows_kernel": "slice 9"}
# the window dump runs only through the public dump_windows: no tracking
# path launches it
DUMP = "dump_windows_kernel"
PROBE_REPLACES = (
    "scripts/probe_pallas_patch.py:26 (_kernel), "
    "scripts/microbench_gather.py:133 (patch_kernel), "
    "scripts/probe_pallas_variants.py:25 (make_kernel)")
SOURCE = "android_svo_tpu_torch/csrc/patch_kernels.cu"
PROBE_SOURCE = "android_svo_tpu_torch/csrc/gather_probe_kernels.cu"
POSE_SOURCE = "android_svo_tpu_torch/csrc/pose_kernels.cu"
POSE = "pose_gn_kernel"
ALIGN = "sparse_align_kernel"
POSE_ROWS = (912, 768)    # the arena's rows at 752x480 (the cells) and
                          # at 640x480 (phases 4-8)
N_FRAMES = 40
PROBE_SIZES = (2048, 32768)   # the reference's N, and 16x it
N_ORBIT = 148            # bench.py's full orbit (make_poses(148, 0.02))
SCAN_START, SCAN_LEN = 40, 24
SCAN_TOL = 0.02          # scan (no BA) vs the default path (BA at its
                         # keyframes): PERF.md section 2's ATE limit
JAX_ATE_HOST = 0.00151   # BENCH_r05.json, 148-frame orbit with local BA
# phase 8b: tests/test_edgelet.py's relaxed thresholds (set for 320x240) on
# phase 4's base; the 640x480 camera has the same 420 px focal length, so
# the sweep moves the image as far, and the grid has four times the cells
EDGE_CFG = dict(edgelet_detection=True, epi_search_1d=True, max_n_kfs=8,
                loba_n_iter=0, ransac_n_trials=128, img_align_n_iter=15,
                init_min_disparity=15.0, init_min_kps=60,
                init_min_tracked=30, init_min_inliers=25, quality_min_fts=25,
                min_reproj_matches=20, min_pose_opt_edges=12,
                kfselect_mindist=0.03)
N_EDGE = 20              # tests/test_edgelet.py's sweep
# the JAX FrameHandler's ATE on phase 8b's configuration, poses and texture
# size at 640x480 on the CPU (its own texture: the noise band differs):
# `JAX_PLATFORMS=cpu python tests/_torch_jax_edgelet_ate.py`
JAX_ATE_EDGE = 0.003722   # bootstrap on frame 4, 0 failures, 5 keyframes
RELOC_R05 = {"reloc_entered_at": 19, "recovered_at": 22, "ate": 0.00723}
DATASET_STAMP0 = 1403636579763555584   # MH_01's first cam0 stamp, 20 Hz
CKPT_AT = 100            # phase 9 checkpoints after this frame
OVERLAY_EVERY = 10       # phase 9 draws every 10th tracked frame


class CheckFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def require_path_launches(launches, what, absent=()):
    """A tracking path's launch counts: every patch kernel launched but
    those in `absent` and the window dump, which must not launch."""
    for name, cnt in launches.items():
        if name == DUMP or name in absent:
            require(cnt == 0, f"{name} launched on the {what} path")
        else:
            require(cnt > 0, f"{name} was not launched on the {what} path")


def reset_launches():
    """Set the tracking path's launch counts to 0: the patch kernels',
    pose_gn_kernel's and sparse_align_kernel's."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import pose_gn as pg
    from android_svo_tpu_torch.ops import sparse_align_gn as sg
    pk.reset_launch_counts()
    pg.reset_launch_counts()
    sg.reset_launch_counts()


def path_launches() -> dict:
    """The tracking path's launch counts: the patch kernels',
    pose_gn_kernel's and sparse_align_kernel's."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import pose_gn as pg
    from android_svo_tpu_torch.ops import sparse_align_gn as sg
    return {**pk.LAUNCHES, **pg.LAUNCHES, **sg.LAUNCHES}


def require_pose_per_frame(launches, n_units, what, unit="tracked frame"):
    """One pose_gn_kernel and one sparse_align_kernel launch per tracked
    frame (or batched step)."""
    for name in (POSE, ALIGN):
        require(launches[name] == n_units, f"{name} launched "
                f"{launches[name]} times on the {what} path for {n_units} "
                f"{unit}s")


def log(msg):
    print(msg, flush=True)


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


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            int(bytes_moved), int(flops))


def scan_bound(x, n_steps):
    """Least time for the scan's work on x's segments with `n_steps`
    positions each: a live step inside the level's margin samples and
    scores the patch (~15 flops per pixel); the others are only placed and
    tested (~10 flops); the reference is centred once.  Bytes: the distinct
    pixels the scored steps' 9x9 footprints touch, the inputs read once, the
    outputs written once."""
    import torch
    n = int(x["lvl"].shape[0])
    h, w = x["h"], x["w"]
    stack = x["stack"]
    L, hp, wp = stack.shape
    k = torch.clamp(n_steps.long(), 0, 100)
    j = torch.arange(100, device=k.device)
    t = torch.clamp(j[None] / torch.clamp(k - 1, min=1)[:, None], max=1.0)
    pos = (x["uv_a"][:, None] * (1 - t[..., None])
           + x["uv_b"][:, None] * t[..., None])
    lvl = x["lvl"].long()[:, None].expand(n, 100)
    wl, hl = (w >> lvl).float(), (h >> lvl).float()
    m = 6.0                                  # half + 2
    scored = ((j[None] < k[:, None]) & (pos[..., 0] >= m)
              & (pos[..., 0] < wl - 1 - m) & (pos[..., 1] >= m)
              & (pos[..., 1] < hl - 1 - m))
    corner = torch.floor(pos[scored]).long() - 4
    r = torch.arange(9, device=k.device)
    rows = corner[:, None, None, 1] + r[None, :, None]
    cols = corner[:, None, None, 0] + r[None, None, :]
    mask = torch.zeros(L * hp * wp, dtype=torch.bool, device=k.device)
    mask[((lvl[scored][:, None, None] * hp + rows) * wp + cols)
         .reshape(-1)] = True
    n_scored = int(scored.sum())
    return bound(
        int(mask.sum()) * 4 + n * (64 * 4 + 16 + 4 + 4) + n * 8,
        n_scored * 64 * 15 + int(k.sum()) * 10 + n * 64 * 2)


def scan_spacing(x, patch_ab):
    """The mean distance between a seed's consecutive scan positions, in
    level pixels, of the gate's scan and of its /path form, as a line."""
    steps = {"gate": x["nsteps"],
             "path": patch_ab.path_steps(x["uv_a"], x["uv_b"])}
    return "scan spacing, mean level px between positions: " + ", ".join(
        f"{k} {patch_ab.mean_spacing(x['uv_a'], x['uv_b'], v):.4f}"
        for k, v in steps.items())


def check_forms(calls, valid):
    """Kernel against plain version for `calls` (name -> fn(use_pallas),
    single or batched) with the kernel gate's bounds: patches within 0.02
    on the live slots of `valid`; the scan's score within 2.0 where both
    are finite, at least 80% of seeds finite, and best_t within 1e-3 but on
    at most 1% of seeds within one step (1/99): at the path's 0.7 px two
    neighbouring positions score within rounding of each other, and the
    plain version rounds the blend apart from the kernel (which matches the
    parent's kernel bit for bit, tools/patch_ab.py).  Returns {name: max
    |d|}; raises CheckFailed beyond a bound."""
    import torch
    live = valid.reshape(-1)
    errs = {}
    for name, fn in calls.items():
        k, p = fn(True), fn(False)
        k = k if isinstance(k, tuple) else (k,)
        p = p if isinstance(p, tuple) else (p,)
        if name.startswith("epi_scan_kernel"):
            (tk, sk), (tp, sp) = ([o.reshape(-1) for o in out]
                                  for out in (k, p))
            fin = torch.isfinite(sk) & torch.isfinite(sp)
            require(int(fin.sum()) >= 0.8 * fin.numel(),
                    f"{name}: only {int(fin.sum())}/{fin.numel()} finite")
            dts = (tk - tp)[fin].abs()
            dt = float(dts.max())
            ds = float((sk - sp)[fin].abs().max())
            moved = int((dts > 1e-3).sum())
            require(dt <= 1.0 / 99 + 1e-6 and moved <= 0.01 * fin.numel()
                    and ds <= 2.0,
                    f"{name}: best_t max|d| {dt} ({moved} seeds past 1e-3), "
                    f"score max|d| {ds}")
            errs[name] = max(dt, ds)
            if moved:
                log(f"{name}: {moved} of {fin.numel()} seeds pick a step "
                    f"next to the plain version's (scores within {ds:.4f})")
        else:
            d = max(float((a.reshape(live.numel(), -1)[live]
                           - b.reshape(live.numel(), -1)[live]).abs().max())
                    for a, b in zip(k, p))
            require(d <= 0.02, f"{name}: max|d| {d} > 0.02")
            errs[name] = d
    return errs


def kernel_bounds(x, pk):
    """Least time for each kernel's work on this run's inputs: every input
    byte read once (for the image, only the pixels the patches touch, capped
    at the planes' size), every output byte written once, and the fp32
    operations the data needs (bilinear sample ~11 flops/px; the scan and
    ICLK loops counted with this run's step and update counts)."""
    import torch
    from android_svo_tpu_torch.tools import patch_ab
    n = int(x["lvl"].shape[0])
    h, w = x["h"], x["w"]
    stack = x["stack"]
    L, hp, wp = stack.shape
    planes = 4 * sum((h >> l) * (w >> l) for l in range(3))
    out = {}
    # sample: 4x4 patches on the level-2 substack (the GN-iteration call)
    sub_bytes = 4 * (h >> 2) * (w >> 2)
    touched = min(n * 5 * 5 * 4, sub_bytes)
    out["sample_patches_kernel"] = bound(
        touched + n * (4 + 8 + 1) + n * 16 * 4, n * 16 * 11)
    # the 1D alignment's sampler: 8x8 patches (9x9 footprints) of the live
    # features at their levels; every slot's patch is written
    live = int(x["valid_mixed"].sum())
    out["sample_patches_kernel/align1d"] = bound(
        min(live * 9 * 9 * 4, planes) + n * (4 + 8 + 1) + n * 64 * 4,
        live * 64 * 11)
    # sparse alignment's reference patches: 4x4 with gradients on the
    # substack, a 6x6 grid of samples (7x7 pixels) per feature, the patch
    # and both differences written
    out["sample_patches_kernel/ref_grad"] = bound(
        min(n * 7 * 7 * 4, sub_bytes) + n * (4 + 8 + 1) + 3 * n * 16 * 4,
        n * (36 * 11 + 16 * 4))
    out["epi_scan_kernel"] = scan_bound(x, x["nsteps"])
    out["epi_scan_kernel/path"] = scan_bound(
        x, patch_ab.path_steps(x["uv_a"], x["uv_b"]))
    # ICLK: patch footprint with the +-2 px start offset.  Both kernels
    # form the Hessian and its inverse themselves (~8 flops per template
    # pixel plus the 3x3 inverse; no hinv read) and write uv, mean and
    # converged (13 B); the window kernel's gates add ~9 flops per pixel.
    foot = min(n * 13 * 13 * 4, planes)
    for name, window in (("align_iclk_kernel", False),
                         ("align_iclk_window_kernel", True)):
        upd = pk.count_iclk_updates(
            x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"], x["init"],
            x["valid"], 10, h, w, window)
        evals = upd + n                        # + the final probe
        flops = evals * (64 * 19 + 15) + n * (64 * 8 + 60)
        ins, outs = n * (3 * 64 * 4 + 4 + 8 + 1), n * 13
        if window:
            out[name + "/ungated"] = bound(foot + ins + outs, flops)
            flops += n * 64 * 9
        out[name] = bound(foot + ins + outs, flops)
    # dump_windows: the distinct pixels of the valid rows' windows read
    # once; every row's window (zeros for a dead row) and origin written
    # once; lvl, uv and valid read once.  No arithmetic to count.
    _, org = pk.dump_windows_plain(stack, x["lvl"], x["dump_uv"])
    live = x["valid_mixed"]
    sx = org[live, 0].long().clamp(0, wp - pk.DUMP_WC)
    sy = org[live, 1].long().clamp(0, hp - pk.DUMP_WR)
    lv = x["lvl"][live].long().clamp(0, L - 1)
    dev = stack.device
    rows = sy[:, None, None] + torch.arange(pk.DUMP_WR, device=dev)[
        None, :, None]
    cols = sx[:, None, None] + torch.arange(pk.DUMP_WC, device=dev)[
        None, None, :]
    seen = torch.zeros(L * hp * wp, dtype=torch.bool, device=dev)
    seen[((lv[:, None, None] * hp + rows) * wp + cols).reshape(-1)] = True
    out[DUMP] = bound(int(seen.sum()) * 4 + n * (4 + 8 + 1)
                      + n * (pk.DUMP_WR * pk.DUMP_WC * 4 + 8), 0)
    return out


def grid_sample_ms(planes, px, py):
    """One PyTorch call computing a bilinear sampler's function:
    grid_sample (bilinear, border clamp) of the (C, H, W) planes at the
    pixels (px, py).  Returns (ms per call, device ms of its kernel)."""
    import torch
    import torch.nn.functional as F
    from android_svo_tpu_torch.utils.profiling import device_ms
    _, h, w = planes.shape
    grid = torch.stack([2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1],
                       -1)[None]
    im = planes[None].contiguous()

    def call():
        return F.grid_sample(im, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    return time_ms(call), device_ms(call, "grid_sampler")


def library_sample_ms(x):
    """grid_sample on the sparse-align sampler's inputs: 4x4 patches on the
    substack."""
    import torch
    sub = x["sub"]
    offs = torch.arange(4, device=sub.device, dtype=torch.float32) - 2
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    px = x["sub_uv"][:, None, 0] + ox.reshape(1, -1)
    py = x["sub_uv"][:, None, 1] + oy.reshape(1, -1)
    return grid_sample_ms(sub, px, py)


def library_align1d_ms(x):
    """grid_sample on the 1D alignment's sampler inputs: 8x8 patches at
    each feature's level of the 3-level stack, as one 3-D (trilinear)
    grid_sample whose depth coordinate lands exactly on the level's plane.
    Returns (ms per call, device ms of its kernel)."""
    import torch
    import torch.nn.functional as F
    from android_svo_tpu_torch.ops import interp
    from android_svo_tpu_torch.utils.profiling import device_ms
    stack = x["stack"]
    L, hp, wp = stack.shape
    offs = interp.patch_offsets(4, device=stack.device)
    px = x["uv"][:, None, 0] + offs[None, :, 0]
    py = x["uv"][:, None, 1] + offs[None, :, 1]
    pz = x["lvl"].float()[:, None].expand_as(px)
    grid = torch.stack([2 * px / (wp - 1) - 1, 2 * py / (hp - 1) - 1,
                        2 * pz / (L - 1) - 1], -1).reshape(1, -1, 8, 8, 3)
    vol = stack[None, None].contiguous()

    def call():
        return F.grid_sample(vol, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    return time_ms(call), device_ms(call, "grid_sampler")


def library_dump_ms(stack, lvl, uv, valid, pk):
    """grid_sample on the window dump's inputs: the (L, Hp, Wp) stack (or
    each of a (B, L, Hp, Wp) batch's) as one volume, sampled with
    mode="nearest" at every window's integer pixel centres, depth on the
    clamped level's plane: the same pixels the dump copies.  Returns (ms
    per call, device ms of its kernel, whether its valid rows equal the
    dump's plain version's)."""
    import torch
    import torch.nn.functional as F
    from android_svo_tpu_torch.utils.profiling import device_ms
    batched = stack.dim() == 4
    vol = (stack[:, None] if batched else stack[None, None]).contiguous()
    if not batched:
        lvl, uv, valid = lvl[None], uv[None], valid[None]
    L, hp, wp = stack.shape[-3:]
    wins, org = pk.dump_windows_batched(vol[:, 0], lvl, uv, valid,
                                        use_pallas=False)
    sx = org[..., 0].clamp(0, wp - pk.DUMP_WC).float()[..., None, None]
    sy = org[..., 1].clamp(0, hp - pk.DUMP_WR).float()[..., None, None]
    sz = lvl.clamp(0, L - 1).float()[..., None, None]
    cc = torch.arange(pk.DUMP_WC, device=stack.device, dtype=torch.float32)
    rr = torch.arange(pk.DUMP_WR, device=stack.device, dtype=torch.float32)
    px = (sx + cc).expand(*lvl.shape, pk.DUMP_WR, pk.DUMP_WC)
    py = (sy + rr[:, None]).expand_as(px)
    grid = torch.stack([2 * px / (wp - 1) - 1, 2 * py / (hp - 1) - 1,
                        (2 * sz / (L - 1) - 1).expand_as(px)], -1)

    def call():
        return F.grid_sample(vol, grid, mode="nearest", padding_mode="border",
                             align_corners=True)

    same = bool(torch.equal(call()[:, 0][valid], wins[valid]))
    return time_ms(call), device_ms(call, "grid_sampler"), same


def probe_bound(img, uv, variant):
    """Least time for one probe call: the distinct pixels its windows touch
    (clamped to the image) read once, uv read once, the patches written
    once; ~11 fp32 flops per output pixel."""
    import torch
    from android_svo_tpu_torch.ops import gather_probe as gp
    h, w = img.shape
    oy, ox = gp.window_origin(uv, variant, h, w)
    r = torch.arange(gp.P + 1, device=uv.device)
    rows = (oy[:, None, None] + r[None, :, None]).clamp(0, h - 1)
    cols = (ox[:, None, None] + r[None, None, :]).clamp(0, w - 1)
    mask = torch.zeros(h * w, dtype=torch.bool, device=uv.device)
    mask[(rows * w + cols).reshape(-1)] = True
    n = uv.shape[0]
    return bound(int(mask.sum()) * 4 + n * 8 + n * gp.P * gp.P * 4,
                 n * gp.P * gp.P * 11)


def library_probe_ms(img, uv):
    """grid_sample on the probe's inputs: variant A's function, every patch
    pixel of every uv."""
    from android_svo_tpu_torch.ops import gather_probe as gp, interp
    offs = interp.patch_offsets(gp.P // 2, device=uv.device)
    px = uv[:, None, 0] + offs[None, :, 0]
    py = uv[:, None, 1] + offs[None, :, 1]
    return grid_sample_ms(img[None], px, py)


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


def edge_poses(synthetic, n, device):
    """tests/test_edgelet.py's sweep: 0.04 per frame in x, 0.012 in y, the
    camera pitched 0.45 rad and turning slowly."""
    return [synthetic.lookdown_pose(
        0.04 * i, 0.012 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i, 0.004 * i),
        device=device) for i in range(n)]


def profiled_dispatch(fn, counts, name, what, attempts=6):
    """`dispatch_counts` of one call of fn, profiled again (up to
    `attempts` times, a pause between) when the kernel launched (its count
    grew) but the profile holds no device activity: the profiler loses a
    record now and then (three times running in one run on an H100)."""
    import torch
    from android_svo_tpu_torch.utils.profiling import dispatch_counts
    kernel = name.split("/")[0]            # a form's kernel
    for attempt in range(attempts):
        before = counts[kernel]
        n_ops, n_dev = dispatch_counts(fn)
        if n_dev or counts[kernel] == before:
            break
        log(f"dispatch {name} ({what}): the kernel launched but the profile "
            f"recorded no device activity (attempt {attempt + 1}); "
            "profiling again")
        torch.cuda.synchronize()
        time.sleep(0.2)
    return n_ops, n_dev


def run_with_plain(cfg, cam, imgs, poses, device, what):
    """`run_sequence` on the kernels and again on the plain versions, each
    with the launch counts set to 0 just before it and read just after.
    Checks that the plain run makes no launch, tracks the same frames and
    puts the camera centres within 5e-3 of the kernel run."""
    reset_launches()
    run = run_sequence(cfg, cam, imgs, poses, device)
    launches = path_launches()
    reset_launches()
    run_p = run_sequence(cfg.replace(use_pallas=False), cam, imgs, poses,
                         device)
    require(all(v == 0 for v in path_launches().values()),
            f"{what}: the plain run launched kernels: {path_launches()}")
    require(run_p["n_fail"] == 0, f"{what}: plain run failed "
            f"{run_p['n_fail']} frames")
    require(run_p["est"].shape == run["est"].shape,
            f"{what}: plain and kernel runs tracked different frame counts")
    dc = float(np.abs(run_p["est"] - run["est"]).max())
    run_p.pop("handler")
    return run, launches, run_p, dc


STAGES = ("pyramid_creation", "sparse_img_align", "reproject",
          "pose_optimizer", "point_optimizer", "depth_filter", "keyframe")


def device_summary(events, per=1, n_top=10):
    """Device busy ms (summed durations of the device activities: kernels,
    copies; the stage annotations excluded), the activities' count and the
    `n_top` that take the most time, each divided by `per`."""
    from torch.autograd import DeviceType
    busy_us, n_dev, by_name = 0.0, 0, {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in STAGES:
            dur = e.time_range.elapsed_us()
            busy_us += dur
            n_dev += 1
            tot, cnt = by_name.get(e.name[:80], (0.0, 0))
            by_name[e.name[:80]] = (tot + dur, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    return {"device_busy_ms": busy_us / 1e3 / per,
            "device_activities": n_dev / per,
            "top_device_ops": [[k, v[0] / 1e3 / per, v[1] / per]
                               for k, v in top]}


def profile_frames(handler, imgs, timestamps=None):
    """torch.profiler over the steady-state tracking frames `imgs` fed to
    a warmed-up `handler`: `device_summary` per frame and, per stage (the
    track_frame ranges), host wall time, the device time of the work
    launched inside it, and its span on the device timeline.  Returns the
    summary and each frame's TrackResult."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = len(imgs)
    stamps = timestamps if timestamps is not None else [0.0] * n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results = [handler.add_image(img, ts) for img, ts in zip(imgs, stamps)]
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    return ({"frames": n, "wall_ms_profiled": wall_ms,
             **device_summary(events, n),
             "stages": stage_table(events, n)}, results)


def stage_table(events, n):
    """Per stage (the track_frame ranges), divided by n: host wall time,
    the device time of the work launched inside it, and its span on the
    device timeline."""
    from torch.autograd import DeviceType
    from android_svo_tpu_torch.utils.profiling import device_time_us
    stages = {k: {"host_ms": 0.0, "device_ms": 0.0, "device_span_ms": 0.0}
              for k in STAGES}
    for e in events:
        if e.name in STAGES:
            st = stages[e.name]
            dur = e.time_range.elapsed_us()
            if e.device_type == DeviceType.CUDA:
                st["device_span_ms"] += dur / 1e3 / n
            else:
                st["host_ms"] += dur / 1e3 / n
                st["device_ms"] += device_time_us(e) / 1e3 / n
    return stages


def profile_call(fn, reps=3):
    """Host ms (synchronised) and dispatch ms of fn, and `device_summary`
    of one more call under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    host, dispatch = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dispatch.append((t1 - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {"host_ms": statistics.median(host),
            "dispatch_ms": statistics.median(dispatch),
            **device_summary(prof.events(), n_top=5)}


def run_sequence(cfg, cam, imgs, poses, device):
    import torch
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.evals.trajectory import ate_rmse

    handler = fh.FrameHandler(cam, cfg, device=device)
    est, gt, est_frames, track_ms, results = [], [], [], [], []
    n_fail = n_kf = 0
    kf_ms = []
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
            est_frames.append(i)
        if was_default:
            track_ms.append(dt)
            results.append(res.result)
            n_fail += res.result == pipeline.RES_FAILURE
            n_kf += res.result == pipeline.RES_IS_KEYFRAME
            if res.result == pipeline.RES_IS_KEYFRAME:
                kf_ms.append(dt)
    est = np.array(est)
    gt = np.array(gt)
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("inf")
    return {"stage": handler.stage, "n_fail": int(n_fail), "n_kf": int(n_kf),
            "ate": ate, "est": est, "est_frames": est_frames, "gt": gt,
            "n_tracked_frames": len(track_ms),
            "median_ms": statistics.median(track_ms) if track_ms else None,
            "results": results, "handler": handler,
            "median_kf_ms": statistics.median(kf_ms) if kf_ms else None,
            "n_local_ba": handler.n_local_ba,
            "n_kf_total": int(handler.vo.kfs.valid.sum())}


def yuv_rgb_reference(y, u, v):
    """float64 numpy of data/yuv.py's conversion (the reference's
    fixed-point BT.601 constants over 1024)."""
    yf = y.astype(np.float64)
    uf = np.repeat(np.repeat(u.astype(np.float64), 2, 0), 2, 1) - 128.0
    vf = np.repeat(np.repeat(v.astype(np.float64), 2, 0), 2, 1) - 128.0
    yy = np.maximum(yf - 16.0, 0.0) * (1192.0 / 1024.0)
    rgb = np.stack([yy + (1634.0 / 1024.0) * vf,
                    yy - (833.0 / 1024.0) * vf - (400.0 / 1024.0) * uf,
                    yy + (2066.0 / 1024.0) * uf], axis=-1)
    return np.clip(rgb, 0.0, 255.0)


def dataset_phase(dev, label, workdir):
    """Phase 9: the dataset path at EuRoC MH_01 cam0's geometry (752x480,
    radtan).  Returns its numbers; raises CheckFailed on any check."""
    import torch
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.data import euroc, native_feeder, synthetic
    from android_svo_tpu_torch.data import yuv
    from android_svo_tpu_torch.evals.trajectory import ate_rmse
    from android_svo_tpu_torch.geometry.camera import PinholeCamera
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    from android_svo_tpu_torch.utils.checkpoint import (load_handler,
                                                        save_handler)
    from android_svo_tpu_torch.viz import Visualizer, overlay

    t_phase = time.perf_counter()
    w, h = euroc.MH01_CAM0["resolution"]
    # ---- a. the patch kernels at the padded 752x480 stack ----------------
    x = silicon_gate.gate_inputs(n=768, h=h, w=w, seed=0, device=dev)
    gate = silicon_gate.run_gate(x)
    torch.cuda.synchronize()
    log(f"dataset gate at {w}x{h} (stack {tuple(x['stack'].shape)}): "
        + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in gate.detail.items()}))
    require(gate.ok, f"kernel gate at {w}x{h} failed: {gate.failures}")

    # ---- b. render the orbit through MH_01 cam0 and write the ASL tree ---
    fx, fy, cx, cy = euroc.MH01_CAM0["intrinsics"]
    dist = euroc.MH01_CAM0["distortion_coefficients"]
    cam = PinholeCamera.create(w, h, fx, fy, cx, cy, *dist, device=dev)
    tex = synthetic.make_texture(torch.Generator().manual_seed(0), 2048,
                                 device=dev)
    poses = make_poses(synthetic, N_ORBIT, 0.02, dev)
    q8 = torch.stack([torch.round(torch.clamp(synthetic.render(tex, cam, p),
                                              0, 255)).to(torch.uint8)
                      for p in poses])
    stamps = [DATASET_STAMP0 + i * 50_000_000 for i in range(N_ORBIT)]
    root = os.path.join(workdir, "MH01_synthetic")
    t0 = time.perf_counter()
    paths = euroc.write_euroc(
        root, q8.cpu().numpy(), stamps, euroc.MH01_CAM0,
        np.stack([p.t.cpu().numpy() for p in poses]),
        np.stack([p.q.cpu().numpy() for p in poses]))
    write_s = time.perf_counter() - t0

    # ---- c. load; YUV; the H2D copy of one frame --------------------------
    seq = euroc.load_euroc(root, device=dev)
    for name in ("fx", "fy", "cx", "cy", "dist"):
        got = getattr(seq.camera, name)
        require(got.device.type == dev.type, f"loaded camera's {name} is on "
                f"{got.device}, not {dev}")
        want = getattr(cam, name)
        require(torch.equal(got, want),
                f"loaded camera's {name} {got} != written {want}")
    require((seq.camera.width, seq.camera.height) == (w, h)
            and not seq.camera.distortion_free,
            "loaded camera's size or distortion differs from the written")
    require(seq.paths() == paths and len(seq) == N_ORBIT,
            "the loader lists other frames than were written")
    gen = torch.Generator().manual_seed(9)
    y_pl = q8[0][:, :640].contiguous()
    u_pl = torch.randint(0, 256, (240, 320), generator=gen,
                         dtype=torch.uint8).to(dev)
    v_pl = torch.randint(0, 256, (240, 320), generator=gen,
                         dtype=torch.uint8).to(dev)
    rgb = yuv.yuv420_to_rgb(y_pl, u_pl, v_pl)
    yuv_err = float(np.abs(rgb.double().cpu().numpy() - yuv_rgb_reference(
        y_pl.cpu().numpy(), u_pl.cpu().numpy(), v_pl.cpu().numpy())).max())
    yuv_ms = time_ms(lambda: yuv.yuv420_to_rgb(y_pl, u_pl, v_pl))
    # the feeder's per-frame copy: one frame from pinned memory to the card
    pinned = q8[0].float().cpu().pin_memory()
    on_card = torch.empty(pinned.shape, device=dev)
    copy_ms = time_ms(lambda: on_card.copy_(pinned, non_blocking=True))
    log(f"dataset load [{label}]: {N_ORBIT} frames at {w}x{h} written in "
        f"{write_s:.2f} s; H2D copy of one frame from pinned memory "
        f"{copy_ms:.4f} ms; yuv420_to_rgb 640x480 max |d| vs float64 "
        f"{yuv_err:.2e}, {yuv_ms:.4f} ms")
    require(yuv_err <= 1e-3, f"yuv420_to_rgb max |d| {yuv_err} > 1e-3")

    # ---- d. track the feeder's frames; e. checkpoint at CKPT_AT ----------
    cfg = SVOConfig(init_min_disparity=20.0, max_n_kfs=8)
    handler = fh.FrameHandler(seq.camera, cfg, device=dev)
    feeder = native_feeder.NativeFrameFeeder(seq.paths(), device=dev)
    ckpt = os.path.join(workdir, "ckpt")
    ppm_dir = os.path.join(workdir, "overlay")
    viz = corners = None
    frames, est, gt, track_ms, kf_ms, tail_a = [], [], [], [], [], []
    n_fail = n_tracked = 0
    cube_in_front = []          # (frame written, all cube corners ahead)
    order = []
    reset_launches()
    for i, frame in feeder:
        order.append(i)
        frames.append(frame)
        was_default = handler.stage == fh.STAGE_DEFAULT_FRAME
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = handler.add_image(frame, seq.timestamps[i])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if handler.stage == fh.STAGE_DEFAULT_FRAME:
            t_wc = res.t_wc if res.t_wc is not None else res.T_cw.inverse().t
            est.append(t_wc.cpu().numpy().astype(np.float64))
            gt.append(seq.gt_at(seq.timestamps[i]))
            if viz is None:
                # the cube on the first camera's optical axis at the map's
                # scene depth, a fifth of that depth wide
                depth = cfg.map_scale
                viz = Visualizer(ppm_dir, seq.camera,
                                 cube_center=(0.0, 0.0, depth),
                                 cube_size=0.2 * depth)
                corners = torch.tensor(overlay._CORNERS * viz.cube_size
                                       + np.array(viz.cube_center),
                                       dtype=torch.float32, device=dev)
        if was_default:
            track_ms.append(dt)
            n_fail += res.result == pipeline.RES_FAILURE
            if res.result == pipeline.RES_IS_KEYFRAME:
                kf_ms.append(dt)
            if n_tracked % OVERLAY_EVERY == 0:
                out = viz(frame, res.T_cw, handler.vo.last.ftr_px,
                          handler.vo.last.ftr_valid)
                ahead = bool((res.T_cw.apply(corners)[:, 2] > 1e-3).all())
                faces = {tuple(c) for c in overlay.FACE_COLORS}
                drawn = bool(faces & {tuple(c) for c in out.reshape(-1, 3)})
                cube_in_front.append((i, ahead, drawn))
            n_tracked += 1
        if i == CKPT_AT:
            save_handler(ckpt, handler)
        elif i > CKPT_AT:
            tail_a.append(res.T_cw.t.cpu().numpy())
    launches = path_launches()
    wait_ms = feeder.wait_s * 1e3 / N_ORBIT
    feeder.close()
    ate = ate_rmse(np.array(est), np.array(gt)) if len(est) >= 3 else \
        float("inf")
    per_frame = {k: v / max(n_tracked, 1) for k, v in launches.items()}
    n_kf, n_ba = int(handler.vo.kfs.valid.sum()), handler.n_local_ba
    log(f"dataset path [{label}]: {N_ORBIT} frames from the feeder, stage "
        f"{handler.stage}, tracked frames {n_tracked}, failures {n_fail}, "
        f"keyframes after bootstrap {len(kf_ms)}, local BA runs "
        f"{n_ba}, ATE {ate:.6f}, median "
        f"{statistics.median(track_ms):.2f} ms/frame, keyframe frames "
        f"{statistics.median(kf_ms) if kf_ms else float('nan'):.2f} ms; "
        f"feeder wait {wait_ms:.4f} ms/frame")
    log(f"launches on the dataset path: {json.dumps(launches)}; per tracked "
        f"frame {json.dumps(per_frame)}")
    require(handler.stage == fh.STAGE_DEFAULT_FRAME,
            "dataset path did not reach DEFAULT")
    require(n_fail == 0, f"dataset path: {n_fail} tracking failures")
    require(n_ba >= 1, "dataset path never ran local BA")
    require_path_launches(launches, "dataset")
    require_pose_per_frame(launches, n_tracked, "dataset")
    require(math.isfinite(ate) and ate <= 0.02,
            f"dataset path ATE {ate} > 0.02")
    # every decoded frame, kept to the end: exact (decode, and no pinned
    # slot rewritten under a pending copy), and its 640x480 Y plane as the
    # app's camera gives it, converted on the card
    require(order == list(range(N_ORBIT)),
            f"the feeder yielded frames {order}, not 0-{N_ORBIT - 1}")
    for i, frame in enumerate(frames):
        require(frame.device.type == dev.type
                and torch.equal(frame, q8[i].float()),
                f"decoded frame {i} differs from its uint8 image")
        require(torch.equal(yuv.yuv420_to_gray(q8[i][:, :640].contiguous()),
                            frame[:, :640]),
                f"yuv420_to_gray of frame {i}'s Y plane differs from the "
                "feeder's frame")
    log(f"dataset decode [{label}]: all {N_ORBIT} frames exact after the "
        "run; yuv420_to_gray bit-exact")

    # ---- e. resume from the checkpoint and run the tail again; its first
    # six frames profiled (where a steady-state frame's time goes here)
    load_handler(ckpt, handler)
    tail = range(CKPT_AT + 1, N_ORBIT)
    prof, results = profile_frames(handler, [frames[i] for i in tail[:6]],
                                   [seq.timestamps[i] for i in tail[:6]])
    results += [handler.add_image(frames[i], seq.timestamps[i])
                for i in tail[6:]]
    tail_b = [res.T_cw.t.cpu().numpy() for res in results]
    tail_d = float(np.abs(np.array(tail_a) - np.array(tail_b)).max())
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / statistics.median(
        track_ms)
    prof["results"] = [res.result for res in results[:6]]
    log(f"dataset profile [{label}]: frames {tail[0]}-{tail[5]} (results "
        f"{prof['results']}), {prof['device_activities']:.1f} device "
        f"activities and {prof['device_busy_ms']:.2f} ms busy per frame, "
        f"idle share {prof['idle_share']:.3f}")
    log(f"resume from frame {CKPT_AT}: tail of {len(tail_b)} frames, T_cw.t "
        f"max |d| {tail_d:.3e} (limit 1e-6)")
    require(tail_d <= 1e-6, f"resumed tail differs by {tail_d} > 1e-6")

    # ---- f. the overlay -----------------------------------------------------
    ppms = sorted(os.listdir(ppm_dir))
    log(f"overlay: {len(ppms)} PPMs for {len(cube_in_front)} calls; (frame, "
        f"cube ahead, cube drawn): {cube_in_front}")
    require(len(ppms) == len(cube_in_front) > 0,
            f"{len(ppms)} PPMs for {len(cube_in_front)} overlay calls")
    require(any(a for _, a, _ in cube_in_front),
            "the cube was never in front of the camera")
    for i, ahead, drawn in cube_in_front:
        require(drawn or not ahead, f"frame {i}: the cube is in front of "
                "the camera but no face colour was drawn")
    return {"card": label, "frames": N_ORBIT, "resolution": [w, h],
            "traj": (np.array(est), np.array(gt)), "ate": ate, "keyframes": len(kf_ms), "keyframes_live": n_kf,
            "local_ba_runs": n_ba, "tracked": n_tracked,
            "median_ms": statistics.median(track_ms),
            "median_kf_ms": statistics.median(kf_ms) if kf_ms else None,
            "feeder_wait_ms_per_frame": wait_ms,
            "h2d_copy_ms_per_frame": copy_ms,
            "write_s": write_s, "yuv_rgb_err": yuv_err, "yuv_rgb_ms": yuv_ms,
            "tail_max_abs_d": tail_d, "overlay_ppms": len(ppms),
            "launches": launches, "launches_per_frame": per_frame,
            "gate_err": gate.max_abs_err, "profile": prof,
            "phase_s": time.perf_counter() - t_phase}


N_SEQ = 11               # BASELINE.json: "all 11 EuRoC sequences, one host"
N_BATCH = 30             # phase 10b's batched frames
N_SINGLE = 10            # of them, rerun as single steps and compared
N_PROFILE = 3            # batched steps profiled after the window
N_B1 = 10                # steps of the B=1 batched run
SEQ_PREROLL = 4          # bootstrap frames before each orbit
BA_SIZES = (2048, 16384)  # loba_point_budget; BA_PROFILE.json's largest P


def seq_poses(synthetic, s, n, device):
    """Phase 10b's sequence s: a pre-roll of 0.15 per frame along x
    (enough disparity for the default init_min_disparity of 50 px, as
    `make_poses`'s pre-roll is at 20), then an orbit of its own, starting
    at phase 2 pi s / 11 and taking 148 - 6 s frames per turn (so the
    sequences reach their keyframes at different steps), pitched 0.45 rad
    and turning slowly as in `make_poses`."""
    phi = 2.0 * math.pi * s / N_SEQ
    n_turn = 148 - 6 * s
    R, r = 0.5, 0.16
    poses = []
    for i in range(n):
        k = SEQ_PREROLL - i
        if k > 0:
            x, y, j = -0.15 * k, 0.0, 0
        else:
            j = -k
            ph = phi + 2.0 * math.pi * j / n_turn
            x = R * (math.sin(ph) - math.sin(phi))
            y = r * (math.cos(ph) - math.cos(phi))
        poses.append(synthetic.lookdown_pose(
            x, y, -3.0, (0.45 + 0.0008 * j, -0.0008 * j, 0.001 * j),
            device=device))
    return poses


def batched_bounds(frames, pk):
    """The batched forms' bounds: each frame's bytes and operations
    (`kernel_bounds`), summed over the batch."""
    per = [kernel_bounds(x, pk) for x in frames]
    return {name: bound(sum(p[name][2] for p in per),
                        sum(p[name][3] for p in per)) for name in per[0]}


def library_sample_batched_ms(xb):
    """grid_sample on the batched sparse-align sampler's inputs: 4x4
    patches on each frame's level-2 substack, the B substacks as one
    (B, 1, rows, cols) input."""
    import torch
    import torch.nn.functional as F
    from android_svo_tpu_torch.utils.profiling import device_ms
    sub = xb["sub"]                              # (B, 1, rows, cols)
    B, _, h, w = sub.shape
    offs = torch.arange(4, device=sub.device, dtype=torch.float32) - 2
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    px = xb["sub_uv"][..., None, 0] + ox.reshape(1, 1, -1)
    py = xb["sub_uv"][..., None, 1] + oy.reshape(1, 1, -1)
    grid = torch.stack([2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1], -1)
    im = sub.contiguous()

    def call():
        return F.grid_sample(im, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    return time_ms(call), device_ms(call, "grid_sampler")


def batched_phase(dev, label, workdir):
    """Phase 10: the batched multi-sequence step and the sharded paths at
    EuRoC MH_01 cam0's geometry.  Returns its numbers; raises CheckFailed
    on any check."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data import euroc, synthetic
    from android_svo_tpu_torch.entry import sparse_ba_problem
    from android_svo_tpu_torch.evals.trajectory import ate_rmse
    from android_svo_tpu_torch.geometry.camera import PinholeCamera
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    from android_svo_tpu_torch.ops import sparse_align
    from android_svo_tpu_torch.parallel.ba import local_ba
    from android_svo_tpu_torch.parallel.mesh import mesh_shape
    from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
    from android_svo_tpu_torch.tools import patch_ab
    from android_svo_tpu_torch.tools.sharded_rank import (config_arrays,
                                                           spawn_ranks)
    from android_svo_tpu_torch.utils.checkpoint import save_state
    from android_svo_tpu_torch.utils.profiling import device_ms

    t_phase = time.perf_counter()
    w, h = euroc.MH01_CAM0["resolution"]
    res = {"card": label, "batch": N_SEQ, "resolution": [w, h]}

    # ---- 10a. the batched kernels at B=11, 752x480, 768 features each ------
    frames, xb = silicon_gate.batched_gate_inputs(N_SEQ, n=768, h=h, w=w,
                                                  seed=0, device=dev)
    gate = silicon_gate.run_batched_gate(frames, xb)
    torch.cuda.synchronize()
    log(f"batched gate B={N_SEQ} at {w}x{h} (stack "
        f"{tuple(xb['stack'].shape)}): " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in gate.detail.items()}))
    require(gate.ok, f"batched kernel gate failed: {gate.failures}")
    calls = silicon_gate.batched_kernel_calls(xb)
    # phase 3's two extra forms, batched: the gate's bounds against the
    # batched plain version, each frame bit for bit its single launch
    extra = patch_ab.extra_calls(xb, batched=True)
    gate.max_abs_err.update(check_forms(extra, xb["valid"]))
    for name, fn in extra.items():
        before = pk.LAUNCHES[silicon_gate.kernel_of(name)]
        out = fn(True)
        require(pk.LAUNCHES[silicon_gate.kernel_of(name)] - before == 1,
                f"batched {name}: more than one launch for a batch")
        out = out if isinstance(out, tuple) else (out,)
        for b, x in enumerate(frames):
            one = patch_ab.extra_calls(x)[name](True)
            one = one if isinstance(one, tuple) else (one,)
            require(all(silicon_gate.same_bits(o[b], s1)
                        for o, s1 in zip(out, one)),
                    f"batched {name}: frame {b} differs from its single "
                    f"launch")
    calls.update(extra)
    log(f"batched extra forms B={N_SEQ}: 1 launch each, each frame bit for "
        f"bit its single launch, max |d| vs plain "
        f"{json.dumps({k: gate.max_abs_err[k] for k in extra})}; "
        f"{scan_spacing(xb, patch_ab)} [{label}]")
    bounds = batched_bounds(frames, pk)
    names = ("sample_patches_kernel", "sample_patches_kernel/ref_grad",
             "epi_scan_kernel", "epi_scan_kernel/path", "align_iclk_kernel",
             "align_iclk_window_kernel", DUMP)
    # every dispatch profile before any timing profile, as in phase 3 (a
    # device-only profile just before has left the next one without device
    # records)
    ops = {}
    for name in names:
        fn = calls[name]
        ops[name], n_dev = profiled_dispatch(lambda: fn(True), pk.LAUNCHES,
                                             name, f"batched B={N_SEQ}")
        require(n_dev == 1, f"batched {name}: {n_dev} device activities "
                "per call")
        # the batched ICLK wrappers read the (B, N) rows in place: their
        # three output allocations (the parent's flattening made 13 ops)
        require(not name.startswith("align_iclk") or ops[name] <= 3,
                f"batched {name}: {ops[name]} ATen ops per call")
    lib = {"sample_patches_kernel": library_sample_batched_ms(xb)}
    l_ms, l_dev, lib_same = library_dump_ms(
        xb["stack"], xb["lvl"], xb["dump_uv"], xb["valid_mixed"], pk)
    lib[DUMP] = (l_ms, l_dev)
    log(f"grid_sample (3-D, nearest) on the {N_SEQ} stacks for the batched "
        f"{DUMP} (one call): {l_ms:.4f} ms, device {l_dev} ms, valid rows "
        f"equal to the batched plain version's {lib_same} [{label}]")
    require(lib_same, "the batched dump's grid_sample copies other pixels")
    forms = {}
    for name in names:
        fn = calls[name]
        kernel = silicon_gate.kernel_of(name)
        n_ops, n_dev = ops[name], 1
        k_ms = time_ms(lambda: fn(True))
        p_ms = time_ms(lambda: fn(False), iters=5, warmup=1)
        d_ms = device_ms(lambda: fn(True), kernel)
        singles = [{**silicon_gate.gate_calls(x),
                    **patch_ab.extra_calls(x)}[name] for x in frames]
        s_ms = time_ms(lambda: [c(True) for c in singles], iters=10)
        forms[name] = {
            "ms": k_ms, "kernel_ms": d_ms, "plain_ms": p_ms,
            "singles_ms": s_ms, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "host_ops_per_call": n_ops,
            "max_abs_err": gate.max_abs_err.get(name, 0.0),
            "launches_per_call": 1,
            "library_ms": lib.get(name, (None, None))[0],
            "library_kernel_ms": lib.get(name, (None, None))[1]}
        log(f"batched {name} B={N_SEQ}: wrapper {k_ms:.4f} ms, device "
            f"{'n/a' if d_ms is None else f'{d_ms:.4f}'} ms, plain "
            f"{p_ms:.4f} ms, {N_SEQ} single launches {s_ms:.4f} ms, bound "
            f"{bounds[name][0]:.5f} ms ({bounds[name][1]}), {n_ops} ops and "
            f"{n_dev} device activity per call [{label}]")
    lib_s = lib["sample_patches_kernel"]
    log(f"grid_sample on the {N_SEQ} substacks (one call): {lib_s[0]:.4f} "
        f"ms, device {lib_s[1]} ms [{label}]")
    res["kernels"] = forms
    del frames, xb, calls

    # ---- 10b. 11 sequences at MH_01 cam0's geometry, batched --------------
    fx, fy, cx, cy = euroc.MH01_CAM0["intrinsics"]
    dist = euroc.MH01_CAM0["distortion_coefficients"]
    cam = PinholeCamera.create(w, h, fx, fy, cx, cy, *dist, device=dev)
    cfg = SVOConfig()
    dims = st.arena_dims(cfg, w, h)
    n_frames = SEQ_PREROLL + 8 + N_BATCH + N_PROFILE
    states, windows, gts, boot_at = [], [], [], []
    t0 = time.perf_counter()
    for s in range(N_SEQ):
        tex = synthetic.make_texture(torch.Generator().manual_seed(s), 2048,
                                     device=dev)
        poses = seq_poses(synthetic, s, n_frames, dev)
        handler = fh.FrameHandler(cam, cfg, device=dev)
        i = 0
        while handler.stage != fh.STAGE_DEFAULT_FRAME and i < SEQ_PREROLL + 8:
            handler.add_image(synthetic.render(tex, cam, poses[i]))
            i += 1
        require(handler.stage == fh.STAGE_DEFAULT_FRAME,
                f"sequence {s} did not bootstrap in {i} frames")
        boot_at.append(i - 1)
        states.append(handler.vo)
        win = poses[i:i + N_BATCH + N_PROFILE]
        windows.append(torch.stack([synthetic.render(tex, cam, p)
                                    for p in win]))
        gts.append(np.stack([p.t.cpu().numpy() for p in win]))
        del handler
    torch.cuda.synchronize()
    log(f"batched setup: {N_SEQ} sequences bootstrapped at frames "
        f"{boot_at} in {time.perf_counter() - t0:.1f} s")
    frames_b = torch.stack(windows, 1)            # (T, B, H, W)
    vo0 = st.stack_states(states)

    track_b = make_batched_track(cfg, cam, dims)
    vo_b = vo0
    outs, step_ms, per_step, iters_b = [], [], [], []
    reset_launches()
    for k in range(N_BATCH):
        before = path_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vo_b, out = track_b(vo_b, frames_b[k])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        iters_b.append(sparse_align.KERNEL_ITERATIONS.tolist())
        after = path_launches()
        per_step.append({n: after[n] - before[n] for n in before})
        outs.append({"t_wc": out["t_wc"].cpu().numpy(),
                     "t": out["T_cw"].t.cpu().numpy(),
                     "result": out["result"].cpu().numpy()})
    launches_b = path_launches()
    codes = np.stack([o["result"] for o in outs])          # (T, B)
    n_fail = (codes == pipeline.RES_FAILURE).sum(0)
    kf = codes == pipeline.RES_IS_KEYFRAME
    mixed = int(((kf.sum(1) > 0) & (kf.sum(1) < N_SEQ)).sum())
    ates = [ate_rmse(np.stack([o["t_wc"][b] for o in outs]),
                     gts[b][:N_BATCH]) for b in range(N_SEQ)]
    med_b = statistics.median(step_ms)
    log(f"batched run [{label}]: B={N_SEQ}, {N_BATCH} steps, failures per "
        f"sequence {n_fail.tolist()}, keyframes per sequence "
        f"{kf.sum(0).tolist()}, steps with some but not all keyframing "
        f"{mixed}, ATE per sequence {[round(a, 6) for a in ates]}, median "
        f"step {med_b:.2f} ms ({N_SEQ * 1e3 / med_b:.2f} sequence-frames/s)")
    log(f"launches on the batched path: {json.dumps(launches_b)}")
    require(int(n_fail.sum()) == 0, f"batched failures {n_fail.tolist()}")
    require(all(math.isfinite(a) and a <= 0.02 for a in ates),
            f"batched ATE over 0.02: {ates}")
    require(mixed >= 1, "no step where some but not all sequences took a "
            "keyframe")
    require_path_launches(launches_b, "batched")
    require_pose_per_frame(launches_b, N_BATCH, "batched", "batched step")

    # the single step of each sequence over the first N_SINGLE frames
    track = pipeline.make_track_frame(cfg, cam, dims)
    single_ms, d_single = [], 0.0
    for b in range(N_SEQ):
        vo = states[b]
        for k in range(N_SINGLE):
            before = path_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            vo, o = track(vo, frames_b[k, b])
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t1) * 1e3)
            its = sparse_align.KERNEL_ITERATIONS.tolist()
            after = path_launches()
            got = {n: after[n] - before[n] for n in before}
            d = float(np.abs(o["t_wc"].cpu().numpy()
                             - outs[k]["t_wc"][b]).max())
            d_single = max(d_single, d)
            require(int(o["result"]) == int(codes[k, b]),
                    f"step {k}, sequence {b}: single result "
                    f"{int(o['result'])} != batched {int(codes[k, b])}")
            # every kernel launches per batched step what one step does
            for n, cnt in got.items():
                require(per_step[k][n] == cnt,
                        f"step {k}: {n} launched {per_step[k][n]} times "
                        f"batched, sequence {b} alone {cnt}")
                require(per_step[k][n] < N_SEQ * max(cnt, 1),
                        f"step {k}: {n} launched B times as often")
            # each block of the batched alignment stops where the
            # sequence's own loop stops
            require(iters_b[k][b] == its, f"step {k}, sequence {b}: the "
                    f"batched alignment ran {iters_b[k][b]} iterations per "
                    f"level, the single step {its}")
    med_s = statistics.median(single_ms)
    log(f"batched vs single steps [{label}]: first {N_SINGLE} frames of "
        f"every sequence, camera centres max |d| {d_single:.3e} (limit "
        f"1e-4), result codes equal, alignment iterations per level each "
        f"sequence's own; median single step {med_s:.2f} ms "
        f"({1e3 / med_s:.2f} sequence-frames/s)")
    require(d_single <= 1e-4, f"batched vs single centres {d_single} > 1e-4")

    # the same code path at B=1
    track_1 = make_batched_track(cfg, cam, dims)
    vo_1 = st.stack_states(states[:1])
    b1_ms = []
    for k in range(N_B1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vo_1, _ = track_1(vo_1, frames_b[k, :1])
        torch.cuda.synchronize()
        b1_ms.append((time.perf_counter() - t1) * 1e3)
    med_1 = statistics.median(b1_ms)

    # where a batched step's time goes: N_PROFILE steps after the window
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(N_BATCH, N_BATCH + N_PROFILE):
            vo_b, _ = track_b(vo_b, frames_b[k])
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t1) * 1e3 / N_PROFILE
    summ = device_summary(prof.events(), N_PROFILE)
    summ["stages"] = stage_table(prof.events(), N_PROFILE)
    summ["wall_ms_profiled"] = prof_ms
    summ["busy_share"] = summ["device_busy_ms"] / med_b
    summ["idle_share"] = 1.0 - summ["busy_share"]
    del vo_b
    log(f"batched timing [{label}]: median step B={N_SEQ} {med_b:.2f} ms, "
        f"B=1 on the same path {med_1:.2f} ms, single step {med_s:.2f} ms; "
        f"throughput {N_SEQ * 1e3 / med_b:.2f} vs {1e3 / med_s:.2f} "
        f"sequence-frames/s ({N_SEQ * med_s / med_b:.2f}x); profiled "
        f"{summ['device_activities']:.1f} device activities and "
        f"{summ['device_busy_ms']:.2f} ms busy per step, busy share "
        f"{summ['busy_share']:.3f}")
    log("batched step stages (host ms, device ms per step, profiled): "
        + json.dumps({k: [round(v["host_ms"], 2), round(v["device_ms"], 3)]
                      for k, v in summ["stages"].items()}))

    # the batched plain versions: no launch, the same track
    reset_launches()
    track_p = make_batched_track(cfg.replace(use_pallas=False), cam, dims)
    vo_p, d_plain, codes_p = vo0, 0.0, []
    for k in range(N_BATCH):
        vo_p, o = track_p(vo_p, frames_b[k])
        d_plain = max(d_plain, float(np.abs(o["t_wc"].cpu().numpy()
                                            - outs[k]["t_wc"]).max()))
        codes_p.append(o["result"].cpu().numpy())
    del vo_p
    log(f"batched plain run: launches {json.dumps(path_launches())}, failures "
        f"{int((np.stack(codes_p) == pipeline.RES_FAILURE).sum())}, camera "
        f"centres max |d| vs the kernel run {d_plain:.3e} (limit 5e-3)")
    require(all(v == 0 for v in path_launches().values()),
            f"the batched plain run launched kernels: {path_launches()}")
    require(d_plain <= 5e-3, f"batched plain centres {d_plain} > 5e-3")
    res.update({
        "frames": N_BATCH, "boot_frames": boot_at, "ate": ates,
        "failures": n_fail.tolist(), "keyframes": kf.sum(0).tolist(),
        "mixed_keyframe_steps": mixed, "launches": launches_b,
        "launches_per_step": {n: v / N_BATCH for n, v in launches_b.items()},
        "median_step_ms": med_b, "median_step_ms_b1": med_1,
        "median_single_step_ms": med_s,
        "seq_frames_per_s": N_SEQ * 1e3 / med_b,
        "seq_frames_per_s_single": 1e3 / med_s,
        "single_vs_batched_centre_dev": d_single,
        "plain_centre_dev": d_plain, "profile": summ})

    # ---- 10c. the sharded local BA on the card -----------------------------
    focal = float(fx)
    n_core = cfg.loba_num_kfs + 1
    probs, refs = {}, []
    for i, P in enumerate(BA_SIZES):
        # every keyframe of the problem in the core window, as the handler
        # passes the arena with only the core window's observations live
        prob = sparse_ba_problem(P, cfg.max_obs_per_point, n_core,
                                 torch.Generator().manual_seed(i),
                                 n_core=n_core, device=dev)
        ref = local_ba(*prob, focal, cfg)
        ref_ms = time_ms(lambda: local_ba(*prob, focal, cfg), iters=5,
                         warmup=1)
        refs.append((P, [x.cpu().numpy() for x in ref], ref_ms))
        for name, x in zip(("pos", "valid", "obs_kf", "obs_f", "q_kw",
                            "t_kw", "core", "fixed"), prob):
            probs[f"p{i}.{name}"] = x.cpu().numpy()
        probs[f"p{i}.focal"] = np.asarray(focal)
    src = os.path.join(workdir, "ba.npz")
    np.savez(src, n_problems=np.asarray(len(BA_SIZES)), **probs,
             **config_arrays(cfg))
    want_bytes = 4 * (36 * n_core ** 2 + 48 * n_core + 1)
    ba = {}
    for backend, n in (("gloo", 2), ("nccl", torch.cuda.device_count())):
        ranks = spawn_ranks("ba", n, 1, src, workdir, "cuda", backend,
                            extra=("--repeat", "5"), timeout=300)
        for i, (P, (q, t, pos, chi2), ref_ms) in enumerate(refs):
            pre = f"p{i}."
            dq = max(float(np.abs(r[pre + "q"] - q).max()) for r in ranks)
            dt = max(float(np.abs(r[pre + "t"] - t).max()) for r in ranks)
            dp = max(float(np.abs(r[pre + "pos"]
                                  - pos[r[pre + "rows"][0]:
                                        r[pre + "rows"][1]]).max())
                     for r in ranks)
            dc = max(abs(float(r[pre + "chi2"]) - float(chi2))
                     / max(abs(float(chi2)), 1e-12) for r in ranks)
            sizes = [r[pre + "allreduce_bytes"].tolist() for r in ranks]
            ms = statistics.median(float(r[pre + "ms"]) for r in ranks)
            ba[f"{backend}_{P}"] = {
                "ranks": n, "q_dev": dq, "t_dev": dt, "pos_dev": dp,
                "chi2_rel_dev": dc, "allreduces": sizes[0], "ms": ms,
                "unsharded_ms": ref_ms}
            log(f"sharded BA [{label}] {backend} x{n} P={P}: q/t/pos max "
                f"|d| vs local_ba {dq:.2e}/{dt:.2e}/{dp:.2e}, chi2 rel "
                f"{dc:.2e}, all-reduces {sizes[0]}, {ms:.3f} ms per call "
                f"(unsharded {ref_ms:.3f} ms)")
            require(max(dq, dt, dp) <= 1e-5, f"sharded BA {backend} P={P} "
                    f"differs from local_ba by {max(dq, dt, dp)}")
            require(dc <= 1e-4, f"sharded BA {backend} P={P} chi2 rel {dc}")
            require(all(s == [want_bytes] * cfg.loba_n_iter for s in sizes),
                    f"sharded BA {backend} P={P}: all-reduces {sizes}, not "
                    f"{cfg.loba_n_iter} of {want_bytes} bytes")
    res["sharded_ba"] = ba

    # ---- 10d. the sharded step: two gloo ranks on the card ----------------
    n_sh = 4
    ckpt = os.path.join(workdir, "batched_ckpt")
    save_state(ckpt, st.stack_states(states[:n_sh]))
    sh_frames = frames_b[:3, :n_sh]
    src = os.path.join(workdir, "track.npz")
    np.savez(src, width=np.asarray(w), height=np.asarray(h),
             imgs=sh_frames.cpu().numpy(), **config_arrays(cfg),
             **{f"cam.{k}": getattr(cam, k).cpu().numpy()
                for k in ("fx", "fy", "cx", "cy", "dist")})
    vo_r = st.stack_states(states[:n_sh])
    ref = []
    for f in sh_frames:
        vo_r, o = track_b(vo_r, f)
        ref.append({"t": o["T_cw"].t.cpu().numpy(),
                    "result": o["result"].cpu().numpy()})
    del vo_r
    sharded = {}
    # two gloo ranks on the one card as (2, 1) and (1, 2); with more cards,
    # one NCCL rank per card on the (data, map) mesh of the cards
    runs = [("gloo", 2, 2), ("gloo", 2, 1)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("nccl", n_cards, mesh_shape(n_cards)[0]))
    for backend, n, n_data in runs:
        ranks = spawn_ranks("track", n, n_data, src, workdir, "cuda",
                            backend, extra=("--ckpt", ckpt), timeout=300)
        dev_t, same = 0.0, True
        for r in ranks:
            lo, hi = r["rows"]
            for k, o in enumerate(ref):
                dev_t = max(dev_t, float(np.abs(r["t"][k]
                                                - o["t"][lo:hi]).max()))
                same &= bool((r["result"][k] == o["result"][lo:hi]).all())
        layout = f"{backend}_data={n_data},map={n // n_data}"
        sharded[layout] = {"t_dev": dev_t, "results_equal": same}
        log(f"sharded step [{label}] ({layout}, {backend} x{n}): "
            f"{n_sh} sequences, 3 steps, T_cw.t max |d| vs unsharded "
            f"{dev_t:.2e} (limit 1e-4), result codes equal {same}")
        require(dev_t <= 1e-4 and same, f"sharded step ({layout}) differs "
                f"from the unsharded batched step")
    res["sharded_step"] = sharded
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def surface_phase(dev, label, x, traj):
    """Phase 11: the public names of the last slice on the card, on phase
    3's 640x480 gate frame.  Returns its numbers and launches; raises
    CheckFailed on any check."""
    import torch
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.evals.trajectory import ate_rmse, rpe_stats
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops import cuda_build, detect, feature_align
    from android_svo_tpu_torch.ops import interp, pyramid, silicon_gate
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.utils.cache import enable_compilation_cache

    t_phase = time.perf_counter()
    h, w = x["h"], x["w"]
    n = 768
    gen = torch.Generator().manual_seed(11)
    img = pyramid.level_view(x["stack"], 0, h, w)
    uv = (torch.rand((n, 2), generator=gen)
          * torch.tensor([w - 1.0, h - 1.0])).to(dev)
    zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
    cfg = SVOConfig()
    feats = detect.detect_features(pyramid.stack_levels(x["stack"], h, w),
                                   None, cfg)
    lvl_f = feats["level"].to(torch.int32)
    uv_f = feats["px"] / (2.0 ** lvl_f.float())[:, None]
    live = feats["valid"]
    torch.cuda.synchronize()

    pk.reset_launch_counts()
    # a. extract_patches_with_grad against the sampler's gradient form
    ref = interp.extract_patches_with_grad(img, uv, 4)
    ker = pk.sample_patches(img[None], zeros, uv, 4, grad=True)
    # b. the window dump at the detector's features
    wins, org = pk.dump_windows(x["stack"], lvl_f, uv_f, live)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    log(f"launches on the surface path: {json.dumps(launches)}")
    for name in ("sample_patches_kernel", DUMP):
        require(launches[name] > 0,
                f"{name} was not launched on the surface path")
    inside = interp.in_bounds(uv, h, w, 5)
    d_grad = max(float((a - b)[inside].abs().max()) for a, b in zip(ref, ker))
    wins_p, org_p = pk.dump_windows(x["stack"], lvl_f, uv_f, live,
                                    use_pallas=False)
    dump_ok = (torch.equal(org, org_p) and torch.equal(wins[live],
                                                       wins_p[live])
               and not bool(wins[~live].any()))
    log(f"surface [{label}]: extract_patches_with_grad vs "
        f"sample_patches_kernel (grad) max |d| {d_grad:.2e} on "
        f"{int(inside.sum())}/{n} inside (limit 0.02); dump_windows at "
        f"{int(live.sum())}/{live.numel()} detected features: origins and "
        f"live windows equal to the plain version, dead rows zero {dump_ok}")
    require(d_grad <= 0.02, f"extract_patches_with_grad vs the sampler "
            f"kernel: {d_grad} > 0.02")
    require(dump_ok, "dump_windows at the detected features differs from "
            "its plain version")

    # b'. torch.func.vmap of dump_windows over 3 frames' stacks (the op's
    # vmap rule: one launch, equal to the batched form) and over one shared
    # stack (batch stride 0: each frame's rows equal its single launch)
    _, xb3 = silicon_gate.batched_gate_inputs(3, n=n, h=h, w=w, device=dev)
    feats3 = (xb3["lvl"], xb3["dump_uv"], xb3["valid_mixed"])

    def vmapped(in_dims, stk):
        before = pk.LAUNCHES[DUMP]
        out = torch.func.vmap(pk.dump_windows, in_dims=in_dims)(stk, *feats3)
        torch.cuda.synchronize()
        return out, pk.LAUNCHES[DUMP] - before

    (wv, ov), n_batched = vmapped(0, xb3["stack"])
    (wv0, ov0), n_shared = vmapped((None, 0, 0, 0), x["stack"])
    same = silicon_gate.same_bits
    wb, ob = pk.dump_windows_batched(xb3["stack"], *feats3)
    vmap_ok = same(wv, wb) and same(ov, ob)
    singles = [pk.dump_windows(x["stack"], *(f[b] for f in feats3))
               for b in range(3)]
    shared_ok = all(same(wv0[b], w1) and same(ov0[b], o1)
                    for b, (w1, o1) in enumerate(singles))
    log(f"surface [{label}]: torch.func.vmap(dump_windows) over 3 frames' "
        f"stacks / over one shared stack: {n_batched} / {n_shared} launches "
        f"(limit 1 each), equal to dump_windows_batched {vmap_ok}, shared "
        f"stack equal to each frame's single launch {shared_ok}")
    require(n_batched == n_shared == 1, f"vmap of dump_windows: "
            f"{n_batched} / {n_shared} launches, not one per batched call")
    require(vmap_ok, "vmap of dump_windows differs from the batched form")
    require(shared_ok, "vmap of dump_windows on a shared stack differs from "
            "the single launches")
    del xb3, feats3

    # c. align1d on the card against its CPU run, on the 160x120 level
    im2 = pyramid.level_view(x["stack"], 2, h, w)
    h2, w2 = im2.shape
    c = (torch.rand((n, 2), generator=gen)
         * torch.tensor([w2 - 24.0, h2 - 24.0]) + 12.0)
    ang = torch.rand(n, generator=gen) * (2 * math.pi)
    direc = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    init = c + direc * (torch.rand((n, 1), generator=gen) * 3.0 - 1.5)
    valid = torch.rand(n, generator=gen) < 0.9
    im2_cpu = im2.cpu()
    patches = interp.extract_patches_with_grad(im2_cpu, c, 4)
    args = (*patches, direc, init, valid)
    u_c, c_c, _ = feature_align.align1d(im2_cpu, *args, 10)
    u_g, c_g, _ = feature_align.align1d(im2, *(a.to(dev) for a in args), 10)
    d_a1d = float((u_g.cpu() - u_c).abs().max())
    same_flags = torch.equal(c_g.cpu(), c_c)
    log(f"surface [{label}]: align1d on the card vs its CPU run at "
        f"{w2}x{h2}, {n} features: uv max |d| {d_a1d:.2e} (limit 1e-4), "
        f"converged flags equal {same_flags} ({int(c_c.sum())} converged)")
    require(same_flags, "align1d: converged flags differ from the CPU run")
    require(d_a1d <= 1e-4, f"align1d: uv differs from the CPU run by "
            f"{d_a1d} > 1e-4")

    # d. SE3.from_matrix(as_matrix()) on the card
    xi = torch.randn((256, 6), generator=gen) * torch.tensor(
        [1.0, 1.0, 1.0, 0.8, 0.8, 0.8])
    T = SE3.exp(xi.to(dev))
    T2 = SE3.from_matrix(T.as_matrix())
    d_q = float(torch.minimum((T2.q - T.q).abs().amax(-1),
                              (T2.q + T.q).abs().amax(-1)).max())
    d_t = float((T2.t - T.t).abs().max())
    d_m = float((T2.as_matrix() - T.as_matrix()).abs().max())
    log(f"surface [{label}]: SE3.from_matrix(as_matrix()) on the card, 256 "
        f"poses: q max |d| {d_q:.2e} (up to sign), t {d_t:.2e}, matrix "
        f"{d_m:.2e} (limit 1e-5)")
    require(T2.q.device.type == "cuda", "SE3.from_matrix left the card")
    require(max(d_q, d_t, d_m) <= 1e-5, f"SE3 round trip differs by "
            f"{max(d_q, d_t, d_m)} > 1e-5")

    # e. RPE of phase 9's trajectory, beside its ATE
    est, gt = traj
    rpe_mean, rpe_median = rpe_stats(est, gt)
    ate = ate_rmse(est, gt)
    log(f"surface [{label}]: phase 9 trajectory ({len(est)} frames): ATE "
        f"{ate:.6f}, RPE (1 frame) mean {rpe_mean:.6f} median "
        f"{rpe_median:.6f}")
    require(math.isfinite(rpe_mean) and math.isfinite(rpe_median),
            "rpe_stats is not finite")

    # f. the kernel cache: a later build finds the library, starts no nvcc
    lib = cuda_build.build()
    enable_compilation_cache()
    popen = cuda_build.subprocess.Popen

    def no_nvcc(*a, **kw):
        raise CheckFailed(f"build() started {a[0][:1]} with the library "
                          "already built")

    cuda_build.subprocess.Popen = no_nvcc
    try:
        again = cuda_build.build()
    finally:
        cuda_build.subprocess.Popen = popen
    log(f"surface: enable_compilation_cache() -> build() returned {again} "
        "without starting nvcc")
    require(again == lib, f"build() returned {again}, not {lib}")
    return {"card": label, "launches": launches, "grad_max_abs_d": d_grad,
            "dump_equal": dump_ok,
            "vmap_launches": {"stacks": n_batched, "shared_stack": n_shared},
            "vmap_equal": vmap_ok and shared_ok,
            "align1d_uv_max_abs_d": d_a1d,
            "se3_roundtrip_max_abs_d": max(d_q, d_t, d_m),
            "ate_phase9": ate, "rpe_mean": rpe_mean,
            "rpe_median": rpe_median,
            "phase_s": time.perf_counter() - t_phase}


def pose_bound(n: int, n_iter: int, batch: int = 1):
    """Least time of pose_gn_kernel on `batch` frames of n rows: the bytes
    it must move (29 a row read: p_w, f_meas, level, valid; 1 a row
    written: the inlier mask; 72 for the pose, focal and the scalars; 144
    for cov) at the HBM's rate, or its fp32 operations at the fp32 peak:
    a row costs ~36 in a weighted cost (transform, projection, norm, Tukey
    weight) and ~170 in the normal equations (the 2x6 Jacobian, 21 + 6
    products summed over two residuals), so ~242 an iteration (the cost at
    the pose, the system, the cost at the step) and ~235 at the start and
    the end (the residuals, the final system).  The kernel is bound by
    neither: by the latency of its serial iterations."""
    bytes_moved = batch * (n * 30 + 72 + 144)
    flops = batch * n * (242 * n_iter + 235)
    return bound(bytes_moved, flops)


def pose_host_reads(fn):
    """The names of the events in one profiled call of fn that read the
    card back to the host (a 0-d read or a device-to-host copy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.name in ("aten::item", "aten::_local_scalar_dense")
                   or "DtoH" in e.name or "Device -> Host" in e.name})


def pose_phase(dev, label):
    """Phase 3d: pose_gn_kernel against its plain version on the card
    (optimize_pose with use_pallas off: ATen on the card) on the same
    inputs, with the card tests' tolerances (`silicon_gate.compare_pose`),
    at the arena's rows of the cells (912) and of phases 4-8 (768), GN and
    LM, and through torch.func.vmap on 11 sequences of 912 rows (each
    within the tolerances of its plain version and bit for bit its single
    launch).  Each call is one launch and reads nothing back; the ATen ops
    and device activities one call dispatches; the wrapper's time, the
    kernel's device time, the plain version's time and the bound.  Returns
    the numbers of each form (`rows912`, `rows768`, `batched_b11`)."""
    import torch
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import pose_opt
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops import pose_gn as pg
    from android_svo_tpu_torch.ops import silicon_gate
    from android_svo_tpu_torch.utils.profiling import device_ms

    def checked(k, p, args, cfg, what):
        detail, failures = silicon_gate.compare_pose(
            k, p, args, cfg.poseoptim_thresh)
        require(not failures, f"{POSE} ({what}) vs plain: {failures}")
        return detail

    def timed(fn, plain, what, n_ops_limit, n, batch=1):
        n_ops, n_dev = profiled_dispatch(fn, pg.LAUNCHES, POSE, what)
        require(n_dev == 1 and (n_ops_limit is None or n_ops <= n_ops_limit),
                f"{POSE} ({what}) dispatches {n_ops} ATen ops and {n_dev} "
                "device activities per call")
        reads = pose_host_reads(fn)
        require(not reads, f"{POSE} ({what}) reads the card back: {reads}")
        b_ms, b_by, b_bytes, b_flops = pose_bound(n, 10, batch)
        rec = {"ms": time_ms(fn),
               "kernel_ms": device_ms(fn, POSE),
               "plain_ms": time_ms(plain, iters=3 if batch > 1 else 5,
                                   warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": b_bytes,
               "bound_flops": b_flops, "host_ops_per_call": n_ops,
               "device_activities_per_call": n_dev}
        log(f"time {POSE} ({what}): wrapper {rec['ms']:.4f} ms, device "
            f"{rec['kernel_ms']} ms, plain {rec['plain_ms']:.3f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), {n_ops} ATen ops and {n_dev} device "
            f"activity a call, no host read [{label}]")
        return rec

    forms = {}
    for n in POSE_ROWS:
        for method in ("gn", "lm"):
            cfg = SVOConfig(poseoptim_method=method)
            args = silicon_gate.pose_inputs(1, n=n, device=dev)
            pg.reset_launch_counts()
            k = pose_opt.optimize_pose(*args, cfg)
            p = pose_opt.optimize_pose(*args, cfg.replace(use_pallas=False))
            torch.cuda.synchronize()
            require(pg.LAUNCHES[POSE] == 1, f"{POSE} ({n} rows, {method}): "
                    f"{pg.LAUNCHES[POSE]} launches for a kernel call and a "
                    "plain one")
            detail = checked(k, p, args, cfg, f"{n} rows, {method}")
            log(f"{POSE} vs plain, {n} rows, {method}: " + json.dumps(detail))
            if method == "gn":
                forms[f"rows{n}"] = {"gap_px": detail["gap_px"], **timed(
                    lambda: pose_opt.optimize_pose(*args, cfg),
                    lambda: pose_opt.optimize_pose(
                        *args, cfg.replace(use_pallas=False)),
                    f"{n} rows", 7, n)}

    # 11 sequences of 912 rows in one vmapped call, focal shared
    n = POSE_ROWS[0]
    cfg = SVOConfig()
    scenes = [silicon_gate.pose_inputs(10 + s, n=n, outliers=0.05 * (s % 4),
                                       behind=0.02 * (s % 3), device=dev)
              for s in range(N_SEQ)]
    q = torch.stack([sc[0].q for sc in scenes])
    t = torch.stack([sc[0].t for sc in scenes]) + 0.01
    rows = [torch.stack([sc[i] for sc in scenes]) for i in range(1, 5)]
    focal = scenes[0][5]

    def batched(c):
        return torch.func.vmap(lambda q, t, *r: pose_opt.optimize_pose(
            SE3(q=q, t=t), *r, focal, c))(q, t, *rows)

    def frame(out, b):
        return (SE3(q=out[0].q[b], t=out[0].t[b]), *(o[b] for o in out[1:]))

    pg.reset_launch_counts()
    out = batched(cfg)
    out_p = batched(cfg.replace(use_pallas=False))
    torch.cuda.synchronize()
    require(pg.LAUNCHES[POSE] == 1, f"{POSE}: {pg.LAUNCHES[POSE]} launches "
            f"for a vmapped call on {N_SEQ} sequences and its plain run")
    gaps, exact = [], True
    for b in range(N_SEQ):
        args = (SE3(q=q[b], t=t[b]), *(r[b] for r in rows), focal)
        gaps.append(checked(frame(out, b), frame(out_p, b), args, cfg,
                            f"batched, sequence {b}")["gap_px"])
        one = pose_opt.optimize_pose(*args, cfg)
        exact &= all(silicon_gate.same_bits(o, s) for o, s in zip(
            (out[0].q[b], out[0].t[b], *(o[b] for o in out[1:])),
            (one[0].q, one[0].t, *one[1:])))
    require(pg.LAUNCHES[POSE] == 1 + N_SEQ, f"{POSE}: "
            f"{pg.LAUNCHES[POSE]} launches for one batch and {N_SEQ} frames")
    log(f"{POSE} batched, {N_SEQ} x {n} rows: one launch, projection gap "
        f"to plain per sequence {[round(g, 6) for g in gaps]} px (limit "
        f"{silicon_gate.POSE_GAP_PX}), bit for bit the single launches "
        f"{exact}")
    require(exact, f"{POSE}: a batched sequence differs from its single "
            "launch")
    forms[f"batched_b{N_SEQ}"] = {
        "gap_px": max(gaps), "bit_exact": exact,
        **timed(lambda: batched(cfg),
                lambda: batched(cfg.replace(use_pallas=False)),
                f"vmap over {N_SEQ} x {n} rows", None, n, N_SEQ)}
    return forms


def align_bound(n: int, n_iter: int, batch: int = 1, n_levels: int = 3,
                area: int = 16):
    """Least time of sparse_align_kernel on `batch` frames of n rows that
    ran n_iter iterations in all (summed over the frames): the bytes it
    must move (the reference
    side once a level: a flag and the patch, gx and gy a row, 1 + 12 area
    bytes; the points once, 12 a row; the current level planes at most
    once, taken as the 4x4 taps of every row, 4 area bytes a row a level;
    40 written) at the HBM's rate, or its fp32 operations at the fp32
    peak: a row costs ~60 in the transform and projection and ~85 a pixel
    (the bilinear taps, J from gx and gy, 21 + 6 products and chi2) an
    iteration.  The kernel is bound by neither: by the latency of its
    serial iterations."""
    bytes_moved = batch * (n * (12 + n_levels * (1 + 16 * area)) + 40)
    flops = n * n_iter * (60 + 85 * area)
    return bound(bytes_moved, flops)


def align_phase(dev, label):
    """Phase 3e: sparse_align_kernel (sparse_img_align on the card) against
    the plain loop (the same call with use_pallas=False: ATen on the card,
    a host read an iteration) on the same inputs, with the card tests'
    tolerances (`silicon_gate.compare_align`), at the cells' cameras and
    rows (radtan at 752x480, 912 rows; no distortion at 640x480, 768), GN
    and LM, and batched on 11 frames of 912 rows (each within the
    tolerances of its plain loop and bit for bit its single launch,
    iteration counts included).  Each call is the set-up's sampler
    launches and one launch of the kernel, and reads nothing back; the
    ATen ops and device activities one call dispatches; the call's time,
    the kernel's device time, the plain loop's time, the iterations the
    kernel ran (read on the device after the call) and the bound.  Returns
    the numbers of each form (`rows912`, `rows768`, `batched_b11`)."""
    import torch
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.ops import silicon_gate, sparse_align
    from android_svo_tpu_torch.ops import sparse_align_gn as sg
    from android_svo_tpu_torch.utils.profiling import device_ms

    def checked(k, p, args, what):
        detail, failures = silicon_gate.compare_align(k, p, args)
        require(not failures, f"{ALIGN} ({what}) vs plain: {failures}")
        return detail

    def timed(fn, plain, what, n, batch=1):
        fn()
        torch.cuda.synchronize()
        its = sparse_align.KERNEL_ITERATIONS.tolist()
        n_iter = sum(its) if batch == 1 else sum(map(sum, its))
        n_ops, n_dev = profiled_dispatch(fn, sg.LAUNCHES, ALIGN, what)
        reads = pose_host_reads(fn)
        require(not reads, f"{ALIGN} ({what}) reads the card back: {reads}")
        b_ms, b_by, b_bytes, b_flops = align_bound(n, n_iter, batch)
        rec = {"ms": time_ms(fn, iters=20),
               "kernel_ms": device_ms(fn, ALIGN),
               "plain_ms": time_ms(plain, iters=3, warmup=1),
               "iterations": its, "bound_ms": b_ms, "bound_by": b_by,
               "bound_bytes": b_bytes, "bound_flops": b_flops,
               "host_ops_per_call": n_ops,
               "device_activities_per_call": n_dev}
        log(f"time {ALIGN} ({what}): call {rec['ms']:.4f} ms, kernel "
            f"{rec['kernel_ms']} ms on the device for {n_iter} iterations "
            f"{its}, plain loop {rec['plain_ms']:.3f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), {n_ops} ATen ops and {n_dev} device "
            f"activities a call (the set-up's included), no host read "
            f"[{label}]")
        return rec

    forms = {}
    for camera in ("radtan", "pinhole"):
        n = silicon_gate.ALIGN_ROWS[camera]
        for method in ("gn", "lm"):
            cfg = SVOConfig()
            args = silicon_gate.align_inputs(1, camera, device=dev)
            sg.reset_launch_counts()
            k = sparse_align.sparse_img_align(*args, cfg, method=method)
            p = sparse_align.sparse_img_align(
                *args, cfg.replace(use_pallas=False), method=method)
            torch.cuda.synchronize()
            require(sg.LAUNCHES[ALIGN] == 1, f"{ALIGN} ({n} rows, {method}):"
                    f" {sg.LAUNCHES[ALIGN]} launches for a kernel call and "
                    "a plain one")
            detail = checked(k, p, args, f"{n} rows, {method}")
            log(f"{ALIGN} vs plain, {camera}, {n} rows, {method}: "
                + json.dumps(detail))
            if method == "gn":
                forms[f"rows{n}"] = {"gap_px": detail["gap_px"], **timed(
                    lambda: sparse_align.sparse_img_align(*args, cfg),
                    lambda: sparse_align.sparse_img_align(
                        *args, cfg.replace(use_pallas=False)),
                    f"{camera}, {n} rows", n)}

    # 11 frames of 912 rows in one launch, the camera shared
    n = silicon_gate.ALIGN_ROWS["radtan"]
    cfg = SVOConfig()
    scenes = [silicon_gate.align_inputs(10 + s, "radtan", device=dev,
                                        behind=0.02 * (s % 3),
                                        margin=0.1 * (s % 2))
              for s in range(N_SEQ)]
    batch = silicon_gate.stack_align_inputs(scenes)
    sg.reset_launch_counts()
    T, n_tr, chi2 = sparse_align.sparse_img_align(*batch, cfg, batched=True)
    its_b = sparse_align.KERNEL_ITERATIONS.tolist()
    require(sg.LAUNCHES[ALIGN] == 1, f"{ALIGN}: {sg.LAUNCHES[ALIGN]} "
            f"launches for a batched call on {N_SEQ} frames")
    gaps, exact = [], True
    for b, sc in enumerate(scenes):
        one = sparse_align.sparse_img_align(*sc, cfg)
        exact &= (all(silicon_gate.same_bits(o, w) for o, w in zip(
            (T.q[b], T.t[b], n_tr[b], chi2[b]),
            (one[0].q, one[0].t, one[1], one[2])))
            and its_b[b] == sparse_align.KERNEL_ITERATIONS.tolist())
        p = sparse_align.sparse_img_align(*sc, cfg.replace(use_pallas=False))
        gaps.append(checked(one, p, sc, f"batched, frame {b}")["gap_px"])
    log(f"{ALIGN} batched, {N_SEQ} x {n} rows: one launch, iterations per "
        f"frame {its_b}, projection gap to plain per frame "
        f"{[round(g, 6) for g in gaps]} px (limit "
        f"{silicon_gate.ALIGN_GAP_PX}), bit for bit the single launches "
        f"{exact}")
    require(exact, f"{ALIGN}: a batched frame differs from its single "
            "launch")
    forms[f"batched_b{N_SEQ}"] = {
        "gap_px": max(gaps), "bit_exact": exact,
        **timed(lambda: sparse_align.sparse_img_align(*batch, cfg,
                                                      batched=True),
                lambda: sparse_align.sparse_img_align(
                    *batch, cfg.replace(use_pallas=False), batched=True),
                f"batched, {N_SEQ} x {n} rows", n, N_SEQ)}
    return forms


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
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.ops import cuda_build, interp, silicon_gate
    from android_svo_tpu_torch.ops import gather_probe as gp
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.tools import (microbench_gather, patch_ab,
                                             reloc_demo)
    from android_svo_tpu_torch.utils.profiling import device_ms

    dev = torch.device("cuda")
    # ---- 1. device --------------------------------------------------------
    label = microbench_gather.card_label()
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
    # two forms the gate's own calls leave out (tools/patch_ab.py): the
    # sampler's gradient form on sparse alignment's substack (its reference
    # patches) and the scan on the gate's segments at the tracking path's
    # spacing, held to the gate's bounds and timed with the rest
    extra = patch_ab.extra_calls(x)
    gate.max_abs_err.update(check_forms(extra, x["valid"]))
    calls.update(extra)
    log(f"extra forms vs plain (max |d|): "
        f"{json.dumps({k: gate.max_abs_err[k] for k in extra})}; "
        f"{scan_spacing(x, patch_ab)} [{label}]")
    bounds = kernel_bounds(x, pk)
    lib_ms = {"sample_patches_kernel": library_sample_ms(x),
              "sample_patches_kernel/align1d": library_align1d_ms(x)}
    l_ms, l_dev, lib_same = library_dump_ms(
        x["stack"], x["lvl"], x["dump_uv"], x["valid_mixed"], pk)
    lib_ms[DUMP] = (l_ms, l_dev)
    for name, (l_ms, l_dev) in lib_ms.items():
        log(f"grid_sample for {name}: {l_ms:.4f} ms, device {l_dev} ms "
            f"[{label}]")
    log(f"grid_sample (3-D, nearest) for {DUMP}: valid rows equal to the "
        f"plain version's {lib_same}")
    require(lib_same, "the dump's grid_sample copies other pixels")
    pimg, puv = microbench_gather.make_inputs(seed=1, device=dev)
    # what the redesigned wrappers dispatch per call on the host
    dispatch = {
        "sample_patches_kernel": [
            ("4x4 on the level-2 substack", 4,
             lambda: calls["sample_patches_kernel"](True)),
            ("8x8 with gradients, valid=None", 4,
             lambda: pk.sample_patches(x["stack"], x["lvl"], x["uv"], 4,
                                       grad=True)),
            ("4x4 with gradients on the level-2 substack", 4,
             lambda: calls["sample_patches_kernel/ref_grad"](True)),
            ("8x8 at mixed levels with a valid mask (align1d)", 4,
             lambda: calls["sample_patches_kernel/align1d"](True))],
        "align_iclk_window_kernel": [
            ("8x8, both gates", 3,
             lambda: calls["align_iclk_window_kernel"](True)),
            ("8x8, gates off", 3,
             lambda: calls["align_iclk_window_kernel/ungated"](True))],
        "align_iclk_kernel": [
            ("8x8, 10 iterations", 3,
             lambda: calls["align_iclk_kernel"](True))],
        "epi_scan_kernel": [
            ("8x8, 2-99 steps", 3, lambda: calls["epi_scan_kernel"](True)),
            ("8x8, the path's spacing", 3,
             lambda: calls["epi_scan_kernel/path"](True)),
            ("n_steps_each=None", 3,
             lambda: pk.epi_scan(x["stack"], x["lvl"], x["uv_a"], x["uv_b"],
                                 x["ref"], 100, half=4, h=x["h"],
                                 w=x["w"]))],
        "probe_patches_kernel": [
            ("variant A, N=2048", 1,
             lambda: gp.probe_patches(pimg, puv, "A"))],
        DUMP: [("768 windows, mixed valid, non-finite centres", 3,
                lambda: calls[DUMP](True))],
    }
    host_ops = {}
    for name, cases in dispatch.items():
        counts = gp.LAUNCHES if name in gp.LAUNCHES else pk.LAUNCHES
        for what, limit, fn in cases:
            n_ops, n_dev = profiled_dispatch(fn, counts, name, what)
            log(f"dispatch {name} ({what}): {n_ops} ATen ops, {n_dev} "
                f"device activities per call (limit {limit} and 1)")
            require(n_ops <= limit and n_dev == 1,
                    f"{name} ({what}) dispatches {n_ops} ATen ops and "
                    f"{n_dev} device activities per call")
            host_ops[name] = max(host_ops.get(name, 0), n_ops)
    timing = {}
    for name, fn in calls.items():
        k_ms = time_ms(lambda: fn(True))
        p_ms = time_ms(lambda: fn(False), iters=10, warmup=2)
        try:
            d_ms = device_ms(lambda: fn(True), silicon_gate.kernel_of(name))
        except Exception as e:          # the profiler is optional here
            log(f"profiler unavailable for {name}: {e!r}")
            d_ms = None
        timing[name] = (k_ms, p_ms, d_ms)
        log(f"time {name}: wrapper {k_ms:.4f} ms, device "
            f"{'n/a' if d_ms is None else f'{d_ms:.4f}'} ms, plain "
            f"{p_ms:.4f} ms, bound {bounds[name][0]:.5f} ms "
            f"({bounds[name][1]}) [{label}]")

    log(f"sample_patches wrapper {timing['sample_patches_kernel'][0]:.4f} "
        f"ms vs grid_sample {lib_ms['sample_patches_kernel'][0]:.4f} ms on "
        f"the same inputs, same run [{label}]")
    # the ICLK kernels' fixed cost: the same calls with no iteration (the
    # prologue, the final resample and the gates)
    fixed = {
        "align_iclk_kernel": lambda: pk.align_iclk(
            x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"], x["init"],
            x["valid"], 0, h=x["h"], w=x["w"]),
        "align_iclk_window_kernel": lambda: pk.align_iclk_mxu(
            x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"], x["init"],
            x["valid"], 0, h=x["h"], w=x["w"], zmssd_factor=2000.0,
            min_patch_std=5.0)}
    for name, fn in fixed.items():
        d0 = device_ms(fn, name)
        log(f"time {name} with n_iter=0: device "
            f"{'n/a' if d0 is None else f'{d0:.4f}'} ms (10 iterations: "
            f"{timing[name][2]} ms) [{label}]")
    # the ICLK kernels' layout and residency at phase 3's 768 rows and phase
    # 10a's 11 x 768, from the runtime: registers and local (spill) bytes
    # per thread, resident blocks per SM, waves; no layout may spill
    iclk_res = {}
    for n_rows in (768, 768 * N_SEQ):
        for name in ("align_iclk_kernel", "align_iclk_window_kernel"):
            r = pk.iclk_residency(4, name == "align_iclk_window_kernel",
                                  n_rows)
            iclk_res.setdefault(name, {})[f"rows{n_rows}"] = r
            log(f"residency {name} at {n_rows} rows (8x8): "
                f"{r['registers']} registers, {r['local_bytes']} local "
                f"bytes, {r['blocks_per_sm']} blocks of "
                f"{r['threads_per_block']} threads per SM, {r['blocks']} "
                f"blocks, {r['features_per_warp']} features a warp, "
                f"{r['waves']:.2f} waves on {r['sms']} SMs [{label}]")
            require(r["local_bytes"] == 0,
                    f"{name} spills {r['local_bytes']} bytes a thread at "
                    f"{n_rows} rows")
    # gate_inputs makes the ICLK start x["init"] = uv + off and the scan's
    # segment ends uv -+ seg once, so the timings above hold no elementwise
    # op; this is the size of one
    add_ms = time_ms(lambda: x["uv"] + x["off"])
    log(f"time uv + off (the ICLK start, made outside the timed ICLK "
        f"calls; the scan's two segment ends are two more of its size): "
        f"{add_ms:.4f} ms [{label}]")

    # ---- 3b. probe kernel gate + timings at two sizes ----------------------
    x8 = torch.zeros((8,), device=dev)
    floor_ms = device_ms(lambda: x8 + 1.0, "elementwise_kernel", iters=50)
    log(f"one-launch floor (device time of x8 + 1.0): {floor_ms} ms "
        f"[{label}]")
    probe = {}          # variant -> its numbers at N=2048
    probe_a = {}        # N -> variant A's numbers
    probe_err = 0.0     # max |d| vs plain over every variant and size
    for n_p in PROBE_SIZES:
        img_n, uv_n = ((pimg, puv) if n_p == PROBE_SIZES[0] else
                       microbench_gather.make_inputs(n=n_p, seed=1,
                                                     device=dev))
        ref_a = interp.extract_patches(img_n, uv_n, gp.P // 2)
        for v in gp.VARIANTS:
            out_k = gp.probe_patches(img_n, uv_n, v)
            out_p = gp.probe_patches_plain(img_n, uv_n, v)
            torch.cuda.synchronize()
            d_plain = float((out_k - out_p).abs().max())
            exact = torch.equal(out_k, out_p)
            probe_err = max(probe_err, d_plain)
            require(d_plain <= 1e-5, f"probe variant {v}, N={n_p}: max |d| "
                    f"vs plain {d_plain} > 1e-5")
            d_ext = None
            if v == "A":
                d_ext = float((out_k - ref_a).abs().max())
                require(d_ext <= 1e-4, f"probe variant A, N={n_p}: max |d| "
                        f"vs extract_patches {d_ext} > 1e-4")
            if n_p != PROBE_SIZES[0] and v != "A":
                log(f"probe {v} N={n_p}: max |d| vs plain {d_plain:.2e}, "
                    f"bit-exact {exact}")
                continue

            def call(v=v, img_n=img_n, uv_n=uv_n):
                return gp.probe_patches(img_n, uv_n, v)

            k_ms = time_ms(call)
            p_ms = time_ms(lambda: gp.probe_patches_plain(img_n, uv_n, v),
                           iters=10, warmup=2)
            d_ms = device_ms(call, "probe_patches_kernel")
            rec = {"max_abs_err": d_plain, "bit_exact": exact, "ms": k_ms,
                   "kernel_ms": d_ms, "plain_ms": p_ms,
                   "bound": probe_bound(img_n, uv_n, v)}
            if n_p == PROBE_SIZES[0]:
                probe[v] = rec
            if v == "A":
                rec["max_err_vs_extract"] = d_ext
                rec["library_ms"], rec["library_kernel_ms"] = \
                    library_probe_ms(img_n, uv_n)
                probe_a[n_p] = rec
            log(f"probe {v} N={n_p}: max |d| vs plain {d_plain:.2e}, "
                f"bit-exact {exact}, wrapper {k_ms:.4f} ms, device "
                f"{'n/a' if d_ms is None else f'{d_ms:.5f}'} ms (floor "
                f"{floor_ms} ms), plain {p_ms:.4f} ms, bound "
                f"{rec['bound'][0]:.5f} ms ({rec['bound'][1]}) [{label}]")
        ra = probe_a[n_p]
        log(f"probe A N={n_p}: max |d| vs extract_patches "
            f"{ra['max_err_vs_extract']:.2e}; wrapper {ra['ms']:.4f} ms vs "
            f"grid_sample {ra['library_ms']:.4f} ms (device "
            f"{ra['library_kernel_ms']} ms), same run [{label}]")

    # ---- 3c. the gather microbench (the probe kernel's path) -------------------
    gp.reset_launch_counts()
    mb = microbench_gather.run(log=log)
    probe_launches = gp.LAUNCHES["probe_patches_kernel"]
    log(f"launches on the microbench path: {probe_launches}")
    require(probe_launches > 0, "the microbench did not launch "
            "probe_patches_kernel")
    require(mb["probe"]["A"]["max_err_vs_extract"] <= 1e-4,
            "microbench: probe variant A disagrees with extract_patches")

    # ---- 3d. pose refinement in one launch ---------------------------------
    pose = pose_phase(dev, label)

    # ---- 3e. sparse alignment's loop in one launch -------------------------
    align = align_phase(dev, label)

    # ---- 4. main path on the kernels -------------------------------------------
    cfg = SVOConfig(init_min_disparity=20.0, max_n_kfs=8, loba_n_iter=0)
    cam = synthetic.default_camera(640, 480, device=dev)
    tex = synthetic.make_texture(torch.Generator().manual_seed(0), 2048,
                                 device=dev)
    poses = make_poses(synthetic, 148, 0.02, dev)[:N_FRAMES]
    imgs = [synthetic.render(tex, cam, p) for p in poses]
    torch.cuda.synchronize()

    gate_launches = dict(pk.LAUNCHES)      # phase 3's gate, dispatch, timing
    reset_launches()
    run_k = run_sequence(cfg, cam, imgs, poses, dev)
    launches = path_launches()
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
    require_path_launches(launches, "main")
    require_pose_per_frame(launches, run_k["n_tracked_frames"], "main")

    # ---- 4b. where a tracking frame's time goes (profiled, steady state) --
    warm = fh.FrameHandler(cam, cfg, device=dev)
    for img in imgs[:30]:
        warm.add_image(img)
    prof, _ = profile_frames(warm, imgs[30:36])
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / run_k["median_ms"]
    prof["card"] = label
    print(json.dumps({"profile": prof}), flush=True)

    # ---- 5. reference run on the plain versions --------------------------------
    reset_launches()
    run_p = run_sequence(cfg.replace(use_pallas=False), cam, imgs, poses, dev)
    log(f"plain path [{label}]: stage {run_p['stage']}, failures "
        f"{run_p['n_fail']}, keyframes after bootstrap {run_p['n_kf']}, ATE "
        f"{run_p['ate']:.6f}, median {run_p['median_ms']:.2f} ms/frame")
    require(all(v == 0 for v in path_launches().values()),
            f"plain run launched kernels: {path_launches()}")
    require(run_p["n_fail"] == 0, f"plain run: {run_p['n_fail']} failures")
    require(run_p["est"].shape == run_k["est"].shape,
            "plain and kernel runs tracked different frame counts")
    dc = float(np.abs(run_p["est"] - run_k["est"]).max())
    log(f"camera centres, kernel vs plain run: max |d| {dc:.6f}")
    require(dc <= 5e-3, f"camera centres differ by {dc} > 5e-3")
    require(abs(run_p["n_kf"] - run_k["n_kf"]) <= 1,
            f"keyframes {run_k['n_kf']} vs plain {run_p['n_kf']}")

    # ---- 6. the default configuration: local BA on, full orbit ------------------
    cfg_d = SVOConfig(init_min_disparity=20.0, max_n_kfs=8)
    poses_d = make_poses(synthetic, N_ORBIT, 0.02, dev)
    imgs_d = [synthetic.render(tex, cam, p) for p in poses_d]
    torch.cuda.synchronize()
    reset_launches()
    run_d = run_sequence(cfg_d, cam, imgs_d, poses_d, dev)
    launches_d = path_launches()
    log(f"default path [{label}]: {N_ORBIT} frames, stage {run_d['stage']}, "
        f"tracked frames {run_d['n_tracked_frames']}, failures "
        f"{run_d['n_fail']}, keyframes after bootstrap {run_d['n_kf']}, "
        f"local BA runs {run_d['n_local_ba']}, ATE {run_d['ate']:.6f} (JAX "
        f"ate_host {JAX_ATE_HOST}), median {run_d['median_ms']:.2f} "
        f"ms/frame, keyframe frames {run_d['median_kf_ms']:.2f} ms")
    log(f"launches on the default path: {json.dumps(launches_d)}")
    require(run_d["stage"] == 3, "default path did not reach DEFAULT")
    require(run_d["n_fail"] == 0, f"default path: {run_d['n_fail']} "
            "tracking failures")
    require(run_d["n_local_ba"] >= 1, "default path never ran local BA")
    require(math.isfinite(run_d["ate"]) and run_d["ate"] <= 0.02,
            f"default path ATE {run_d['ate']} > 0.02")
    require_path_launches(launches_d, "default")
    require_pose_per_frame(launches_d, run_d["n_tracked_frames"], "default")
    handler_d = run_d.pop("handler")
    ba_prof = profile_call(lambda: handler_d._run_local_ba(handler_d.vo))
    ba_prof["card"] = label
    print(json.dumps({"local_ba": ba_prof}), flush=True)

    # make_track_scan from a fresh handler's steady state, held against the
    # ground truth and against the handler run above over the same frames
    from android_svo_tpu_torch.evals.trajectory import ate_rmse
    fresh = fh.FrameHandler(cam, cfg_d, device=dev)
    est_s, gt_s = [], []
    for i, img in enumerate(imgs_d[:SCAN_START]):
        res = fresh.add_image(img)
        if fresh.stage == fh.STAGE_DEFAULT_FRAME:
            t_wc = res.t_wc if res.t_wc is not None else res.T_cw.inverse().t
            est_s.append(t_wc.cpu().numpy().astype(np.float64))
            gt_s.append(poses_d[i].t.cpu().numpy().astype(np.float64))
    require(fresh.stage == 3, "fresh handler did not reach DEFAULT")
    vo0 = fresh.vo
    window = torch.stack(imgs_d[SCAN_START:SCAN_START + SCAN_LEN])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vo = vo0
    for img in window:
        vo, _ = fresh._track(vo, img)
    torch.cuda.synchronize()
    t_steps = (time.perf_counter() - t0) * 1e3 / SCAN_LEN
    scan = pipeline.make_track_scan(cfg_d, cam, fresh.dims)
    t0 = time.perf_counter()
    _, outs = scan(vo0, window)
    torch.cuda.synchronize()
    t_scan = (time.perf_counter() - t0) * 1e3 / SCAN_LEN
    twc_scan = outs["t_wc"].cpu().numpy().astype(np.float64)
    scan_frames = range(SCAN_START, SCAN_START + SCAN_LEN)
    ate_scan = ate_rmse(
        np.concatenate([np.array(est_s), twc_scan]),
        np.concatenate([np.array(gt_s), np.stack(
            [poses_d[i].t.cpu().numpy() for i in scan_frames])]))
    row = {f: j for j, f in enumerate(run_d["est_frames"])}
    require(all(f in row for f in scan_frames),
            "the default path lost frames inside the scan window")
    d_scan = float(np.abs(twc_scan - run_d["est"][
        [row[f] for f in scan_frames]]).max())
    n_fail_scan = int((outs["result"] == pipeline.RES_FAILURE).sum())
    log(f"track_scan [{label}]: frames {SCAN_START}-"
        f"{SCAN_START + SCAN_LEN - 1}, failures {n_fail_scan}, ATE with the "
        f"fresh handler's frames {ate_scan:.6f}, t_wc max |d| vs the default "
        f"path (local BA between its frames) {d_scan:.2e}, "
        f"{t_scan:.2f} ms/frame (per-frame steps {t_steps:.2f} ms/frame)")
    require(n_fail_scan == 0, f"track_scan: {n_fail_scan} failures")
    require(math.isfinite(ate_scan) and ate_scan <= 0.02,
            f"track_scan ATE {ate_scan} > 0.02")
    require(d_scan <= SCAN_TOL, f"track_scan t_wc differ from the default "
            f"path by {d_scan} > {SCAN_TOL}")

    # ---- 7. relocalization scenario ------------------------------------------------
    reset_launches()
    rel = reloc_demo.run(
        device=dev, trace=os.path.join(here, "build", "reloc_trace.jsonl"),
        log=log)
    launches_r = path_launches()
    rel["card"] = label
    print(json.dumps({"reloc": rel}), flush=True)
    log(f"reloc [{label}]: entered {rel['reloc_entered_at']} (JAX "
        f"{RELOC_R05['reloc_entered_at']}), recovered {rel['recovered_at']} "
        f"(JAX {RELOC_R05['recovered_at']}), ATE {rel['ate']} (JAX "
        f"{RELOC_R05['ate']}), local BA runs {rel['local_ba_runs']}")
    require(rel["reloc_entered_at"] is not None,
            "reloc: tracking was never lost")
    require(rel["recovered_at"] is not None, "reloc: never recovered")
    require(rel["final_stage"] == 3, "reloc: final stage is not DEFAULT")
    log(f"launches on the reloc path: {json.dumps(launches_r)}")
    require_path_launches(launches_r, "reloc")

    # ---- 8a. Levenberg-Marquardt on phase 4's configuration and frames -------
    from android_svo_tpu_torch.ops import detect, matcher
    cfg_lm = cfg.replace(poseoptim_method="lm", structureoptim_method="lm")
    run_lm, launches_lm, run_lm_p, dc_lm = run_with_plain(
        cfg_lm, cam, imgs, poses, dev, "lm")
    per_lm = {k: v / run_lm["n_tracked_frames"]
              for k, v in launches_lm.items()}
    log(f"lm path [{label}]: stage {run_lm['stage']}, tracked frames "
        f"{run_lm['n_tracked_frames']}, failures {run_lm['n_fail']}, "
        f"keyframes after bootstrap {run_lm['n_kf']}, ATE {run_lm['ate']:.6f} "
        f"(plain {run_lm_p['ate']:.6f}), median {run_lm['median_ms']:.2f} "
        f"ms/frame, keyframe frames {run_lm['median_kf_ms']:.2f} ms, plain "
        f"median {run_lm_p['median_ms']:.2f} ms")
    log(f"launches on the lm path: {json.dumps(launches_lm)}; per tracked "
        f"frame {json.dumps(per_lm)}")
    log(f"camera centres, lm kernel vs plain run: max |d| {dc_lm:.6f}")
    require(run_lm["stage"] == 3, "lm path did not reach DEFAULT")
    require(run_lm["n_fail"] == 0, f"lm path: {run_lm['n_fail']} failures")
    require(run_lm["n_kf"] >= 1, "lm path: no keyframe after bootstrap")
    require(math.isfinite(run_lm["ate"]) and run_lm["ate"] <= 0.02,
            f"lm path ATE {run_lm['ate']} > 0.02")
    require_path_launches(launches_lm, "lm")
    require_pose_per_frame(launches_lm, run_lm["n_tracked_frames"], "lm")
    require(dc_lm <= 5e-3, f"lm path: camera centres differ from the plain "
            f"run by {dc_lm} > 5e-3")

    # ---- 8b. edgelets with the 1D alignment on the edge-rich scene ---------
    cfg_e = SVOConfig(**EDGE_CFG)
    tex_e = synthetic.make_edge_texture(torch.Generator().manual_seed(3),
                                        2048, device=dev)
    poses_e = edge_poses(synthetic, N_EDGE, dev)
    imgs_e = [synthetic.render(tex_e, cam, p) for p in poses_e]
    torch.cuda.synchronize()
    align1d = matcher.align1d_stack
    a1d = {"calls": 0, "host_s": 0.0}

    def timed_align1d(*args, **kw):
        """align1d_stack, with its calls and host time counted on the
        kernel run (the plain run passes use_pallas=False)."""
        t0 = time.perf_counter()
        out = align1d(*args, **kw)
        if kw.get("use_pallas", True):
            a1d["host_s"] += time.perf_counter() - t0
            a1d["calls"] += 1
        return out

    matcher.align1d_stack = timed_align1d
    try:
        run_e, launches_e, run_e_p, dc_e = run_with_plain(
            cfg_e, cam, imgs_e, poses_e, dev, "edgelets")
    finally:
        matcher.align1d_stack = align1d
    n_tr = run_e["n_tracked_frames"]
    per_e = {k: v / n_tr for k, v in launches_e.items()}
    vo_e = run_e["handler"].vo
    n_edge_pts = int((vo_e.points.valid
                      & (vo_e.points.ref_type == detect.FTYPE_EDGELET)).sum())
    n_edge_seeds = int((vo_e.seeds.valid
                        & (vo_e.seeds.ftype == detect.FTYPE_EDGELET)).sum())
    ate_limit = max(0.02, 2 * JAX_ATE_EDGE)
    log(f"edgelet path [{label}]: {N_EDGE} frames, stage {run_e['stage']}, "
        f"tracked frames {n_tr}, failures {run_e['n_fail']}, keyframes "
        f"after bootstrap {run_e['n_kf']}, live edgelet landmarks "
        f"{n_edge_pts}, edgelet seeds {n_edge_seeds}, ATE {run_e['ate']:.6f} "
        f"(limit {ate_limit}, JAX on the CPU {JAX_ATE_EDGE}; plain "
        f"{run_e_p['ate']:.6f}), median {run_e['median_ms']:.2f} ms/frame, "
        f"keyframe frames {run_e['median_kf_ms']:.2f} ms, plain median "
        f"{run_e_p['median_ms']:.2f} ms")
    log(f"launches on the edgelet path: {json.dumps(launches_e)}; per "
        f"tracked frame {json.dumps(per_e)}")
    a1d_calls = a1d["calls"] / n_tr
    a1d_host_ms = a1d["host_s"] * 1e3 / n_tr
    log(f"align1d_stack on the edgelet path (kernel run): {a1d['calls']} "
        f"calls, {a1d_calls:.2f} per tracked frame, host time in it "
        f"{a1d_host_ms:.2f} ms per tracked frame (unsynchronised) of a "
        f"{run_e['median_ms']:.2f} ms median frame [{label}]")
    log("align_iclk_kernel is not on the edgelet path: the 1D refinement "
        "along the epipolar segment (epi_search_1d) replaces it")
    log(f"camera centres, edgelet kernel vs plain run: max |d| {dc_e:.6f}")
    require(run_e["stage"] == 3, "edgelet path did not reach DEFAULT")
    require(run_e["n_fail"] == 0, f"edgelet path: {run_e['n_fail']} "
            "failures")
    require(n_tr >= 10, f"edgelet path: only {n_tr} tracked frames")
    require(n_edge_pts > 0, "no edgelet landmarks in the live map")
    require(n_edge_seeds > 0, "no edgelet seeds in the depth filter")
    require(math.isfinite(run_e["ate"]) and run_e["ate"] <= ate_limit,
            f"edgelet path ATE {run_e['ate']} > {ate_limit}")
    require_path_launches(launches_e, "edgelet",
                          absent=("align_iclk_kernel",))
    require_pose_per_frame(launches_e, n_tr, "edgelet")
    require(dc_e <= 5e-3, f"edgelet path: camera centres differ from the "
            f"plain run by {dc_e} > 5e-3")
    # the align1d host time of the kernel run alone, per call at the seed
    # update's shapes (768 seeds, 8x8, 10 iterations)
    ang = torch.linspace(0, 2 * math.pi, x["lvl"].shape[0], device=dev)
    a1d_args = (x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"],
                torch.stack([torch.cos(ang), torch.sin(ang)], -1), x["init"],
                x["valid"], 10, x["h"], x["w"])
    a1d_ms = time_ms(lambda: matcher.align1d_stack(*a1d_args), iters=20)
    a1d_plain_ms = time_ms(
        lambda: matcher.align1d_stack(*a1d_args, use_pallas=False),
        iters=5, warmup=1)
    log(f"align1d_stack, 768 features, 10 iterations: {a1d_ms:.4f} ms per "
        f"call on the kernels (10 sampler launches), {a1d_plain_ms:.4f} ms "
        f"plain [{label}]")

    # ---- 9. the dataset path at EuRoC MH_01 cam0's geometry ---------------
    build_dir = os.path.join(here, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        ds = dataset_phase(dev, label, workdir)
    log(f"dataset phase: {ds['phase_s']:.1f} s [{label}]")

    # ---- 10. the batched multi-sequence step and the sharded paths, in a
    # process of its own: after phases 3-9 the profiler lost the device
    # records of every batched dispatch profile (three runs on an H100),
    # while a fresh process records them
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        out = os.path.join(workdir, "batched.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--batched-phase", out], cwd=here,
                            timeout=900).returncode
        require(rc == 0, f"phase 10 failed (rc {rc})")
        with open(out) as f:
            bt = json.load(f)
    log(f"batched phase: {bt['phase_s']:.1f} s [{label}]")

    # ---- 11. the last slice's public names on the card ---------------------
    sf = surface_phase(dev, label, x, ds["traj"])
    log(f"surface phase: {sf['phase_s']:.1f} s [{label}]")

    kernels = []
    for name in ("sample_patches_kernel", "align_iclk_window_kernel",
                 "epi_scan_kernel", "align_iclk_kernel"):
        k_ms, p_ms, d_ms = timing[name]
        b_ms, b_by, b_bytes, b_flops = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": KERNEL_META[name], "launches": launches[name],
            "launches_by_path": {"main": launches[name],
                                 "default": launches_d[name],
                                 "reloc": launches_r[name],
                                 "lm": launches_lm[name],
                                 "edgelets": launches_e[name],
                                 "dataset": ds["launches"][name],
                                 "batched": bt["launches"][name]},
            "launches_per_frame": {"lm": per_lm[name],
                                   "edgelets": per_e[name],
                                   "dataset": ds["launches_per_frame"][name]},
            "max_abs_err": gate.max_abs_err.get(name, 0.0),
            "max_abs_err_752x480": ds["gate_err"].get(name, 0.0), "ms": k_ms,
            "kernel_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": b_bytes, "bound_flops": b_flops,
            "library_ms": lib_ms.get(name, (None, None))[0],
            "library_kernel_ms": lib_ms.get(name, (None, None))[1],
            "card": label})
        kernels[-1].update(host_ops_per_call=host_ops[name],
                           redesigned_in=REDESIGNED_IN[name])
        if name in iclk_res:
            kernels[-1]["residency"] = iclk_res[name]
        forms = {}
        for form in timing:
            if form.startswith(name + "/"):
                f_ms, f_p_ms, f_d_ms = timing[form]
                forms[form.split("/")[1]] = {
                    "ms": f_ms, "kernel_ms": f_d_ms, "plain_ms": f_p_ms,
                    "bound_ms": bounds[form][0], "bound_by": bounds[form][1],
                    "max_abs_err": gate.max_abs_err.get(form, 0.0),
                    "max_abs_err_752x480": ds["gate_err"].get(form),
                    "library_ms": lib_ms.get(form, (None, None))[0],
                    "library_kernel_ms": lib_ms.get(form, (None, None))[1]}
        # the batched forms: one launch for the 11 frames of phase 10a
        for form, rec in bt["kernels"].items():
            if form == name or form.startswith(name + "/"):
                forms["_".join([f"batched_b{N_SEQ}"] + form.split("/")[1:])] \
                    = rec
        kernels[-1]["forms"] = forms
    # the window dump: its path is phase 11's public dump_windows; every
    # tracking path holds it at 0 launches
    k_ms, p_ms, d_ms = timing[DUMP]
    b_ms, b_by, b_bytes, b_flops = bounds[DUMP]
    kernels.append({
        "name": DUMP, "route": "cuda", "source": SOURCE,
        "replaces": KERNEL_META[DUMP], "launches": sf["launches"][DUMP],
        "launches_by_path": {"surface": sf["launches"][DUMP],
                             "surface_vmap": sf["vmap_launches"]["stacks"],
                             "surface_vmap_shared_stack":
                                 sf["vmap_launches"]["shared_stack"],
                             "gate_phase3": gate_launches[DUMP],
                             "main": launches[DUMP],
                             "default": launches_d[DUMP],
                             "reloc": launches_r[DUMP], "lm": launches_lm[DUMP],
                             "edgelets": launches_e[DUMP],
                             "dataset": ds["launches"][DUMP],
                             "batched": bt["launches"][DUMP]},
        "max_abs_err": gate.max_abs_err.get(DUMP, 0.0),
        "max_abs_err_752x480": ds["gate_err"].get(DUMP, 0.0), "ms": k_ms,
        "kernel_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "bound_bytes": b_bytes, "bound_flops": b_flops,
        "library_ms": lib_ms[DUMP][0], "library_kernel_ms": lib_ms[DUMP][1],
        "card": label, "host_ops_per_call": host_ops[DUMP],
        "redesigned_in": REDESIGNED_IN[DUMP],
        "forms": {f"batched_b{N_SEQ}": bt["kernels"][DUMP]}})
    pa, big = probe_a[PROBE_SIZES[0]], probe_a[PROBE_SIZES[1]]
    kernels.append({
        "name": "probe_patches_kernel", "route": "cuda",
        "source": PROBE_SOURCE, "replaces": PROBE_REPLACES,
        "launches": probe_launches,
        "launches_by_path": {"microbench": probe_launches},
        "max_abs_err": probe_err,
        "ms": pa["ms"], "kernel_ms": pa["kernel_ms"],
        "plain_ms": pa["plain_ms"], "bound_ms": pa["bound"][0],
        "bound_by": pa["bound"][1], "bound_bytes": pa["bound"][2],
        "bound_flops": pa["bound"][3], "library_ms": pa["library_ms"],
        "library_kernel_ms": pa["library_kernel_ms"],
        "host_ops_per_call": host_ops["probe_patches_kernel"],
        "redesigned_in": REDESIGNED_IN["probe_patches_kernel"],
        "floor_ms": floor_ms,
        f"n{PROBE_SIZES[1]}": {
            "ms": big["ms"], "kernel_ms": big["kernel_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound"][0],
            "bound_by": big["bound"][1], "library_ms": big["library_ms"],
            "library_kernel_ms": big["library_kernel_ms"],
            "max_abs_err": big["max_abs_err"]},
        "variants": {v: {"ms": p["ms"], "kernel_ms": p["kernel_ms"],
                         "plain_ms": p["plain_ms"],
                         "bound_ms": p["bound"][0],
                         "max_abs_err": p["max_abs_err"],
                         "bit_exact": p["bit_exact"]}
                     for v, p in probe.items()},
        "card": label})
    # pose refinement: one launch a tracked frame and a batched step
    by_path = {"main": launches, "default": launches_d, "reloc": launches_r,
               "lm": launches_lm, "edgelets": launches_e,
               "dataset": ds["launches"], "batched": bt["launches"]}
    tracked = {"main": run_k["n_tracked_frames"],
               "default": run_d["n_tracked_frames"],
               "lm": run_lm["n_tracked_frames"], "edgelets": n_tr,
               "dataset": ds["tracked"]}
    kernels.append({
        "name": POSE, "route": "cuda", "source": POSE_SOURCE,
        "replaces": KERNEL_META[POSE], "launches": launches[POSE],
        "launches_by_path": {k: v[POSE] for k, v in by_path.items()},
        "launches_per_frame": {k: by_path[k][POSE] / v
                               for k, v in tracked.items()},
        "launches_per_step": {"batched": bt["launches_per_step"][POSE]},
        **pose["rows912"], "library_ms": None, "library_kernel_ms": None,
        "card": label,
        "forms": {k: v for k, v in pose.items() if k != "rows912"}})
    # sparse alignment's loop: one launch a tracked frame and a batched step
    kernels.append({
        "name": ALIGN, "route": "cuda", "source": POSE_SOURCE,
        "replaces": KERNEL_META[ALIGN], "launches": launches[ALIGN],
        "launches_by_path": {k: v[ALIGN] for k, v in by_path.items()},
        "launches_per_frame": {k: by_path[k][ALIGN] / v
                               for k, v in tracked.items()},
        "launches_per_step": {"batched": bt["launches_per_step"][ALIGN]},
        **align["rows912"], "library_ms": None, "library_kernel_ms": None,
        "card": label,
        "forms": {k: v for k, v in align.items() if k != "rows912"}})
    print(json.dumps({"microbench_gather": mb}), flush=True)
    print(json.dumps({"main_path": {
        "card": label, "ate": run_k["ate"], "ate_plain": run_p["ate"],
        "median_ms": run_k["median_ms"],
        "fps": 1e3 / run_k["median_ms"],
        "median_ms_plain": run_p["median_ms"], "keyframes": run_k["n_kf"],
        "keyframes_plain": run_p["n_kf"], "centre_dev": dc}}), flush=True)
    print(json.dumps({"default_path": {
        "card": label, "frames": N_ORBIT, "ate": run_d["ate"],
        "jax_ate_host": JAX_ATE_HOST, "median_ms": run_d["median_ms"],
        "median_kf_ms": run_d["median_kf_ms"],
        "keyframes": run_d["n_kf"], "local_ba_runs": run_d["n_local_ba"],
        "local_ba_host_ms": ba_prof["host_ms"],
        "local_ba_device_ms": ba_prof["device_busy_ms"],
        "scan_ms_per_frame": t_scan, "steps_ms_per_frame": t_steps,
        "scan_twc_dev": d_scan}}), flush=True)
    print(json.dumps({"variants": {
        "card": label,
        "lm": {"ate": run_lm["ate"], "ate_plain": run_lm_p["ate"],
               "median_ms": run_lm["median_ms"],
               "median_kf_ms": run_lm["median_kf_ms"],
               "median_ms_plain": run_lm_p["median_ms"],
               "keyframes": run_lm["n_kf"], "centre_dev": dc_lm,
               "launches_per_frame": per_lm},
        "edgelets": {"frames": N_EDGE, "tracked": n_tr, "ate": run_e["ate"],
                     "ate_plain": run_e_p["ate"], "jax_ate_cpu": JAX_ATE_EDGE,
                     "median_ms": run_e["median_ms"],
                     "median_kf_ms": run_e["median_kf_ms"],
                     "median_ms_plain": run_e_p["median_ms"],
                     "keyframes": run_e["n_kf"],
                     "edgelet_landmarks": n_edge_pts,
                     "edgelet_seeds": n_edge_seeds, "centre_dev": dc_e,
                     "launches_per_frame": per_e,
                     "align1d_calls_per_frame": a1d_calls,
                     "align1d_host_ms_per_frame": a1d_host_ms,
                     "align1d_ms_per_call": a1d_ms,
                     "align1d_plain_ms_per_call": a1d_plain_ms}}}),
          flush=True)
    print(json.dumps({"dataset": {k: v for k, v in ds.items()
                                  if k not in ("gate_err", "traj")}}),
          flush=True)
    print(json.dumps({"batched": {k: v for k, v in bt.items()
                                  if k != "kernels"}}), flush=True)
    print(json.dumps({"surface": sf}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def batched_main(out_path: str) -> int:
    """Phase 10 alone, its numbers written to `out_path` as JSON (the
    kernels are built already, by phase 2 of the calling run)."""
    import torch
    from android_svo_tpu_torch.ops import cuda_build
    from android_svo_tpu_torch.tools import microbench_gather
    here = os.path.dirname(os.path.abspath(__file__))
    cuda_build.library()
    label = microbench_gather.card_label()
    with tempfile.TemporaryDirectory(
            dir=os.path.join(here, "build")) as workdir:
        bt = batched_phase(torch.device("cuda"), label, workdir)
    with open(out_path, "w") as f:
        json.dump(bt, f, default=lambda o: o.item())     # numpy scalars
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--batched-phase"]:
            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            sys.exit(batched_main(sys.argv[2]))
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
