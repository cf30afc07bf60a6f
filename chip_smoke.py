#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card: every kernel against
its plain version at the tracking path's shapes, then the tracking paths end
to end and the kernel launches each makes.

    python3 chip_smoke.py

It times nothing.  A kernel is timed alone by `tools/patch_ab.py` and
`tools/probe_ab.py`, and in a cell by the benchmark's traced run
(`python3 -m svo_bench.run --trace 1`); the card tests
(`python -m pytest tests/test_torch_cuda.py tests/test_torch_camera_kernel.py
-q --noconftest -o addopts=""`)
hold each kernel at more shapes and edge cases.

Phases (any failed check exits non-zero; the last line is printed only when
every phase passed):
  1. device  — needs torch.cuda; prints the card's name and power limit.
  2. build   — compiles every CUDA source in csrc/ with nvcc (in parallel)
               into one library.
  3. gate    — `ops/silicon_gate.py::path_gate`, which the card tests run
               too: the patch kernels in every form against their plain
               versions, one device activity and a few ATen ops a call, at
               768 rows on 640x480 and on EuRoC cam0's 752x480, and batched
               at 11 x 768 on 752x480 (one launch a batch, each frame bit
               for bit its single launch); no ICLK layout spilling at those
               rows; pose_gn_kernel at 912 and 768 rows and
               sparse_align_kernel on the radtan and pinhole cameras, GN and
               LM, and each batched on 11 frames, against their plain
               versions, reading nothing back; the gather probe against its
               plain version and interp.extract_patches at 2,048 features;
               the radtan camera's two kernels against PinholeCamera's
               plain versions (pixels bit for bit) at 1-8,192 rows and
               batched at 11 x 912.
  4. main    — FrameHandler at 640x480, SVOConfig(init_min_disparity=20,
               max_n_kfs=8, loba_n_iter=0), 40 frames of the bench orbit
               rendered on the card: bootstrap, tracking, keyframes.  Every
               kernel's launch count must grow during this run.
  5. plain   — the same 40 frames with use_pallas=False on the card; the
               launch counts must not move, and the trajectory must agree.
  6. default — FrameHandler at the default configuration with local BA on,
               SVOConfig(init_min_disparity=20, max_n_kfs=8), over the full
               148-frame bench orbit: DEFAULT reached, 0 failures, local BA
               run, every patch kernel launched, ATE <= 0.02; then
               make_track_scan over frames 40-63 from a fresh handler's
               steady state: 0 failures, ATE <= 0.02 with the handler's
               earlier frames, t_wc within 0.02 of the run above (which runs
               local BA between those frames).
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
               in 8a.  Each prints its launches per tracked frame.
  9. dataset — the dataset path at EuRoC MH_01 cam0's geometry (752x480,
               radtan distortion): (b) the 148-frame orbit rendered on the
               card through that camera, quantised to uint8 and written as
               an ASL tree (stdlib PNGs, data.csv at 20 Hz, sensor.yaml,
               ground truth); (c) load_euroc on the card (camera fields as
               written, on the card), yuv420_to_rgb within 1e-3 of a
               float64 reference; (d) FrameHandler at the default
               configuration over the frames the native feeder decodes into
               pinned memory and copies to the card: DEFAULT, 0 failures,
               local BA run, every patch kernel launched, ATE <= 0.02;
               every frame, kept to the end, equal to its uint8 image and
               its 640x480 Y plane through yuv420_to_gray bit-exact; (e)
               checkpoint after frame 100, resume, the tail's T_cw.t within
               1e-6; (f) the overlay on every 10th tracked frame: one PPM
               per call, the cube's faces drawn whenever its corners are in
               front of the camera.
 10. batched — (in a process of its own, started by this script) the
               batched multi-sequence step and the sharded paths at MH_01
               cam0's geometry: (b) 11 sequences (their own textures, seeds
               0-10, and orbits) bootstrapped each in its own FrameHandler
               at the default SVOConfig(), stacked, and tracked by
               make_batched_track for 30 frames: 0 failures, ATE <= 0.02
               per sequence, a step where some but not all take a keyframe;
               the first 10 frames rerun as each sequence's single step
               (camera centres within 1e-4, equal result codes, each kernel
               launched per step as a single step is, each sequence's
               alignment iterations per level its single step's); the
               batched plain run (no launch, centres within 5e-3); (c)
               make_sharded_ba on the card, 2 gloo ranks and an NCCL group
               over every card, P = 2048 and 16384, O=8, NC=5: within 1e-5
               of local_ba, chi2 within 1e-4, exactly loba_n_iter
               all-reduces of 4,564 bytes; (d) make_sharded_track in 2 gloo
               ranks on the card, (data=2, map=1) and (data=1, map=2), and
               on a host of 2 or more cards one NCCL rank per card on their
               (data, map) mesh, 4 sequences from a checkpoint of 10b's
               stacked state, 3 steps: within 1e-4 of the unsharded batched
               step, equal result codes.
 11. surface — the public names the last slice added, on the card, on a
               640x480 gate frame: (a) interp.extract_patches_with_grad on
               one 480x640 level at 768 centres against
               sample_patches_kernel's gradient form on a one-level stack
               (<= 0.02 where the patch and one pixel around it lie
               inside); (b) dump_windows at the detector's features against
               its plain version, and torch.func.vmap(dump_windows) over 3
               frames' stacks (one launch, equal to dump_windows_batched)
               and over one shared stack (one launch, each frame equal to
               its single launch); (c) feature_align.align1d on the card
               against its CPU run (converged flags equal, uv within 1e-4,
               on the 160x120 level); (d) SE3.from_matrix(as_matrix())
               round trip (1e-5); (e) rpe_stats of phase 9's trajectory
               beside its ATE; (f) after enable_compilation_cache(),
               cuda_build.build() returns the built library without
               starting nvcc.  Both kernels must launch; each vmap call of
               the dump is one launch.
Each path (4, 5, 6, 7, 8a and 8b with their plain runs, 9, 10b and its
plain run, 11) runs with the launch counts set to 0 just before it and read
just after; on a tracking path those of the patch kernels, of
pose_gn_kernel and sparse_align_kernel and of the camera kernels, all 0 on
each plain run.  The tracking paths (4, 6, 7, 8a, 8b, 9, 10b) launch every
patch kernel but dump_windows_kernel, which only the public dump_windows
runs (8b also not align_iclk_kernel); there its count must stay 0.  They
launch pose_gn_kernel and sparse_align_kernel once a tracked frame (4, 6,
8a, 8b, 9) and once a batched step (10b; 7, which relocalizes, at least
once).  The radtan paths (9, 10b) launch the camera kernels 7 + 15 times a
tracked frame or batched step without a keyframe, and 10b as many a
batched step as one sequence's step (where its keyframe decision is the
batch's); the pinhole paths (4-8) never.
Prints one JSON line of results per path and ends with one JSON line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the window dump runs only through the public dump_windows: no tracking
# path launches it
DUMP = "dump_windows_kernel"
POSE = "pose_gn_kernel"
ALIGN = "sparse_align_kernel"
# the radtan camera's kernels: only a camera with distortion launches them
# (phases 9 and 10b), 7 cam2world and 15 world2cam / world2cam_uv calls a
# tracked frame or batched step without a keyframe
CAMERA = {"camera_cam2world_kernel": 7, "camera_world2cam_kernel": 15}
N_FRAMES = 40
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


def require_path_launches(launches, what, absent=(), radtan=False):
    """A tracking path's launch counts: every patch kernel launched but
    those in `absent` and the window dump, which must not launch; the
    camera kernels launched on a `radtan` camera's path, else not."""
    for name, cnt in launches.items():
        if name == DUMP or name in absent or (name in CAMERA
                                              and not radtan):
            require(cnt == 0, f"{name} launched on the {what} path")
        else:
            require(cnt > 0, f"{name} was not launched on the {what} path")


def reset_launches():
    """Set the tracking path's launch counts to 0: the patch kernels',
    pose_gn_kernel's, sparse_align_kernel's and the camera kernels'."""
    from android_svo_tpu_torch.ops import camera_kernels as ck
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import pose_gn as pg
    from android_svo_tpu_torch.ops import sparse_align_gn as sg
    pk.reset_launch_counts()
    pg.reset_launch_counts()
    sg.reset_launch_counts()
    ck.reset_launch_counts()


def path_launches() -> dict:
    """The tracking path's launch counts: the patch kernels',
    pose_gn_kernel's, sparse_align_kernel's and the camera kernels'."""
    from android_svo_tpu_torch.ops import camera_kernels as ck
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import pose_gn as pg
    from android_svo_tpu_torch.ops import sparse_align_gn as sg
    return {**pk.LAUNCHES, **pg.LAUNCHES, **sg.LAUNCHES, **ck.LAUNCHES}


def require_camera_per_unit(per_unit, what):
    """The camera kernels' launches of each tracked frame or batched step
    without a keyframe in `per_unit` ({unit: launches}): `CAMERA`."""
    require(per_unit, f"no {what} unit without a keyframe")
    for unit, launches in per_unit.items():
        got = {n: launches[n] for n in CAMERA}
        require(got == CAMERA, f"{what} {unit}: camera kernels launched "
                f"{got}, not {CAMERA}")


def require_pose_per_frame(launches, n_units, what, unit="tracked frame"):
    """One pose_gn_kernel and one sparse_align_kernel launch per tracked
    frame (or batched step)."""
    for name in (POSE, ALIGN):
        require(launches[name] == n_units, f"{name} launched "
                f"{launches[name]} times on the {what} path for {n_units} "
                f"{unit}s")


def log(msg):
    print(msg, flush=True)


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


def run_sequence(cfg, cam, imgs, poses, device):
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.evals.trajectory import ate_rmse

    handler = fh.FrameHandler(cam, cfg, device=device)
    est, gt, est_frames = [], [], []
    n_fail = n_kf = n_tracked = 0
    for i, img in enumerate(imgs):
        was_default = handler.stage == fh.STAGE_DEFAULT_FRAME
        res = handler.add_image(img)
        if handler.stage == fh.STAGE_DEFAULT_FRAME:
            t_wc = res.t_wc if res.t_wc is not None else res.T_cw.inverse().t
            est.append(t_wc.detach().cpu().numpy().astype(np.float64))
            gt.append(poses[i].t.detach().cpu().numpy().astype(np.float64))
            est_frames.append(i)
        if was_default:
            n_tracked += 1
            n_fail += res.result == pipeline.RES_FAILURE
            n_kf += res.result == pipeline.RES_IS_KEYFRAME
    est = np.array(est)
    gt = np.array(gt)
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("inf")
    return {"stage": handler.stage, "n_fail": int(n_fail), "n_kf": int(n_kf),
            "ate": ate, "est": est, "est_frames": est_frames,
            "n_tracked_frames": n_tracked, "handler": handler,
            "n_local_ba": handler.n_local_ba}


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
    from android_svo_tpu_torch.utils.checkpoint import (load_handler,
                                                        save_handler)
    from android_svo_tpu_torch.viz import Visualizer, overlay

    w, h = euroc.MH01_CAM0["resolution"]
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
    paths = euroc.write_euroc(
        root, q8.cpu().numpy(), stamps, euroc.MH01_CAM0,
        np.stack([p.t.cpu().numpy() for p in poses]),
        np.stack([p.q.cpu().numpy() for p in poses]))

    # ---- c. load; YUV -----------------------------------------------------
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
    log(f"dataset load [{label}]: {N_ORBIT} frames at {w}x{h} written and "
        f"loaded; yuv420_to_rgb 640x480 max |d| vs float64 {yuv_err:.2e}")
    require(yuv_err <= 1e-3, f"yuv420_to_rgb max |d| {yuv_err} > 1e-3")

    # ---- d. track the feeder's frames; e. checkpoint at CKPT_AT ----------
    cfg = SVOConfig(init_min_disparity=20.0, max_n_kfs=8)
    handler = fh.FrameHandler(seq.camera, cfg, device=dev)
    feeder = native_feeder.NativeFrameFeeder(seq.paths(), device=dev)
    ckpt = os.path.join(workdir, "ckpt")
    ppm_dir = os.path.join(workdir, "overlay")
    viz = corners = None
    frames, est, gt, tail_a = [], [], [], []
    n_fail = n_tracked = n_kf_added = 0
    cube_in_front = []          # (frame written, all cube corners ahead)
    order, camera_frames = [], {}
    reset_launches()
    for i, frame in feeder:
        order.append(i)
        frames.append(frame)
        was_default = handler.stage == fh.STAGE_DEFAULT_FRAME
        before = path_launches()
        res = handler.add_image(frame, seq.timestamps[i])
        if was_default and res.result == pipeline.RES_NO_KEYFRAME:
            after = path_launches()
            camera_frames[f"frame {i}"] = {n: after[n] - before[n]
                                           for n in CAMERA}
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
            n_fail += res.result == pipeline.RES_FAILURE
            n_kf_added += res.result == pipeline.RES_IS_KEYFRAME
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
    feeder.close()
    ate = ate_rmse(np.array(est), np.array(gt)) if len(est) >= 3 else \
        float("inf")
    per_frame = {k: v / max(n_tracked, 1) for k, v in launches.items()}
    n_kf, n_ba = int(handler.vo.kfs.valid.sum()), handler.n_local_ba
    log(f"dataset path [{label}]: {N_ORBIT} frames from the feeder, stage "
        f"{handler.stage}, tracked frames {n_tracked}, failures {n_fail}, "
        f"keyframes after bootstrap {n_kf_added}, local BA runs {n_ba}, ATE "
        f"{ate:.6f}")
    log(f"launches on the dataset path: {json.dumps(launches)}; per tracked "
        f"frame {json.dumps(per_frame)}")
    require(handler.stage == fh.STAGE_DEFAULT_FRAME,
            "dataset path did not reach DEFAULT")
    require(n_fail == 0, f"dataset path: {n_fail} tracking failures")
    require(n_ba >= 1, "dataset path never ran local BA")
    require_path_launches(launches, "dataset", radtan=True)
    require_pose_per_frame(launches, n_tracked, "dataset")
    require_camera_per_unit(camera_frames, "dataset")
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

    # ---- e. resume from the checkpoint and run the tail again ----------
    load_handler(ckpt, handler)
    tail_b = [handler.add_image(frames[i], seq.timestamps[i]).T_cw.t.cpu()
              .numpy() for i in range(CKPT_AT + 1, N_ORBIT)]
    tail_d = float(np.abs(np.array(tail_a) - np.array(tail_b)).max())
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
            "traj": (np.array(est), np.array(gt)), "ate": ate,
            "keyframes": int(n_kf_added), "keyframes_live": n_kf,
            "local_ba_runs": n_ba, "tracked": n_tracked,
            "yuv_rgb_err": yuv_err, "tail_max_abs_d": tail_d,
            "overlay_ppms": len(ppms), "launches": launches,
            "launches_per_frame": per_frame}


N_SEQ = 11               # BASELINE.json: "all 11 EuRoC sequences, one host"
N_BATCH = 30             # phase 10b's batched frames
N_SINGLE = 10            # of them, rerun as single steps and compared
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


def batched_phase(dev, label, workdir):
    """Phase 10: the batched multi-sequence step and the sharded paths at
    EuRoC MH_01 cam0's geometry.  Returns its numbers; raises CheckFailed
    on any check."""
    import torch
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data import euroc, synthetic
    from android_svo_tpu_torch.entry import sparse_ba_problem
    from android_svo_tpu_torch.evals.trajectory import ate_rmse
    from android_svo_tpu_torch.geometry.camera import PinholeCamera
    from android_svo_tpu_torch.ops import sparse_align
    from android_svo_tpu_torch.parallel.ba import local_ba
    from android_svo_tpu_torch.parallel.mesh import mesh_shape
    from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
    from android_svo_tpu_torch.tools.sharded_rank import (config_arrays,
                                                           spawn_ranks)
    from android_svo_tpu_torch.utils.checkpoint import save_state

    w, h = euroc.MH01_CAM0["resolution"]
    res = {"card": label, "batch": N_SEQ, "resolution": [w, h]}

    # ---- 10b. 11 sequences at MH_01 cam0's geometry, batched --------------
    fx, fy, cx, cy = euroc.MH01_CAM0["intrinsics"]
    dist = euroc.MH01_CAM0["distortion_coefficients"]
    cam = PinholeCamera.create(w, h, fx, fy, cx, cy, *dist, device=dev)
    cfg = SVOConfig()
    dims = st.arena_dims(cfg, w, h)
    n_frames = SEQ_PREROLL + 8 + N_BATCH
    states, windows, gts, boot_at = [], [], [], []
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
        win = poses[i:i + N_BATCH]
        windows.append(torch.stack([synthetic.render(tex, cam, p)
                                    for p in win]))
        gts.append(np.stack([p.t.cpu().numpy() for p in win]))
        del handler
    log(f"batched setup: {N_SEQ} sequences bootstrapped at frames "
        f"{boot_at}")
    frames_b = torch.stack(windows, 1)            # (T, B, H, W)
    vo0 = st.stack_states(states)

    track_b = make_batched_track(cfg, cam, dims)
    vo_b = vo0
    outs, per_step, iters_b = [], [], []
    reset_launches()
    for k in range(N_BATCH):
        before = path_launches()
        vo_b, out = track_b(vo_b, frames_b[k])
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
    log(f"batched run [{label}]: B={N_SEQ}, {N_BATCH} steps, failures per "
        f"sequence {n_fail.tolist()}, keyframes per sequence "
        f"{kf.sum(0).tolist()}, steps with some but not all keyframing "
        f"{mixed}, ATE per sequence {[round(a, 6) for a in ates]}")
    log(f"launches on the batched path: {json.dumps(launches_b)}")
    require(int(n_fail.sum()) == 0, f"batched failures {n_fail.tolist()}")
    require(all(math.isfinite(a) and a <= 0.02 for a in ates),
            f"batched ATE over 0.02: {ates}")
    require(mixed >= 1, "no step where some but not all sequences took a "
            "keyframe")
    require_path_launches(launches_b, "batched", radtan=True)
    require_pose_per_frame(launches_b, N_BATCH, "batched", "batched step")
    require_camera_per_unit({f"step {k}": per_step[k] for k in range(N_BATCH)
                             if not kf[k].any()}, "batched")

    # the single step of each sequence over the first N_SINGLE frames
    track = pipeline.make_track_frame(cfg, cam, dims)
    d_single = 0.0
    for b in range(N_SEQ):
        vo = states[b]
        for k in range(N_SINGLE):
            before = path_launches()
            vo, o = track(vo, frames_b[k, b])
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
            # (the camera's where this sequence's keyframe decision is the
            # batch's: the keyframe insertion calls cam2world)
            for n, cnt in got.items():
                if n in CAMERA and bool(kf[k, b]) != bool(kf[k].any()):
                    continue
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
    log(f"batched vs single steps [{label}]: first {N_SINGLE} frames of "
        f"every sequence, camera centres max |d| {d_single:.3e} (limit "
        f"1e-4), result codes equal, alignment iterations per level each "
        f"sequence's own")
    require(d_single <= 1e-4, f"batched vs single centres {d_single} > 1e-4")

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
        "single_vs_batched_centre_dev": d_single,
        "plain_centre_dev": d_plain})

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
        refs.append((P, [x.cpu().numpy() for x in ref]))
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
                            timeout=300)
        for i, (P, (q, t, pos, chi2)) in enumerate(refs):
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
            ba[f"{backend}_{P}"] = {
                "ranks": n, "q_dev": dq, "t_dev": dt, "pos_dev": dp,
                "chi2_rel_dev": dc, "allreduces": sizes[0]}
            log(f"sharded BA [{label}] {backend} x{n} P={P}: q/t/pos max "
                f"|d| vs local_ba {dq:.2e}/{dt:.2e}/{dp:.2e}, chi2 rel "
                f"{dc:.2e}, all-reduces {sizes[0]}")
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
    return res


def surface_phase(dev, label, traj):
    """Phase 11: the public names of the last slice on the card, on a
    640x480 gate frame (`silicon_gate.gate_inputs`).  Returns its numbers
    and launches; raises CheckFailed on any check."""
    import torch
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.evals.trajectory import ate_rmse, rpe_stats
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops import cuda_build, detect, feature_align
    from android_svo_tpu_torch.ops import interp, pyramid, silicon_gate
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.utils.cache import enable_compilation_cache

    x = silicon_gate.gate_inputs(n=768, h=480, w=640, seed=0, device=dev)
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
            "rpe_median": rpe_median}


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
    from android_svo_tpu_torch.evals.trajectory import ate_rmse
    from android_svo_tpu_torch.ops import cuda_build, detect, silicon_gate
    from android_svo_tpu_torch.tools import microbench_gather, reloc_demo

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

    # ---- 3. every kernel against its plain version at the path's shapes --
    gate = silicon_gate.path_gate(dev)
    torch.cuda.synchronize()
    log("gate: " + json.dumps({k: v or "ok" for k, v in gate.items()}))
    failed = {k: v for k, v in gate.items() if v}
    require(not failed, f"kernel gate failed: {failed}")

    # ---- 4. main path on the kernels -------------------------------------------
    cfg = SVOConfig(init_min_disparity=20.0, max_n_kfs=8, loba_n_iter=0)
    cam = synthetic.default_camera(640, 480, device=dev)
    tex = synthetic.make_texture(torch.Generator().manual_seed(0), 2048,
                                 device=dev)
    poses = make_poses(synthetic, 148, 0.02, dev)[:N_FRAMES]
    imgs = [synthetic.render(tex, cam, p) for p in poses]

    reset_launches()
    run_k = run_sequence(cfg, cam, imgs, poses, dev)
    launches = path_launches()
    log(f"main path [{label}]: stage {run_k['stage']}, tracked frames "
        f"{run_k['n_tracked_frames']}, failures {run_k['n_fail']}, "
        f"keyframes after bootstrap {run_k['n_kf']}, ATE {run_k['ate']:.6f}")
    log(f"launches on the main path: {json.dumps(launches)}")
    require(run_k["stage"] == 3, "main path did not reach DEFAULT")
    require(run_k["n_fail"] == 0, f"{run_k['n_fail']} tracking failures")
    require(run_k["n_kf"] >= 1, "no keyframe inserted after bootstrap")
    require(math.isfinite(run_k["ate"]) and run_k["ate"] <= 0.02,
            f"ATE {run_k['ate']} > 0.02")
    require_path_launches(launches, "main")
    require_pose_per_frame(launches, run_k["n_tracked_frames"], "main")

    # ---- 5. reference run on the plain versions --------------------------------
    reset_launches()
    run_p = run_sequence(cfg.replace(use_pallas=False), cam, imgs, poses, dev)
    log(f"plain path [{label}]: stage {run_p['stage']}, failures "
        f"{run_p['n_fail']}, keyframes after bootstrap {run_p['n_kf']}, ATE "
        f"{run_p['ate']:.6f}")
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
    reset_launches()
    run_d = run_sequence(cfg_d, cam, imgs_d, poses_d, dev)
    launches_d = path_launches()
    log(f"default path [{label}]: {N_ORBIT} frames, stage {run_d['stage']}, "
        f"tracked frames {run_d['n_tracked_frames']}, failures "
        f"{run_d['n_fail']}, keyframes after bootstrap {run_d['n_kf']}, "
        f"local BA runs {run_d['n_local_ba']}, ATE {run_d['ate']:.6f} (JAX "
        f"ate_host {JAX_ATE_HOST})")
    log(f"launches on the default path: {json.dumps(launches_d)}")
    require(run_d["stage"] == 3, "default path did not reach DEFAULT")
    require(run_d["n_fail"] == 0, f"default path: {run_d['n_fail']} "
            "tracking failures")
    require(run_d["n_local_ba"] >= 1, "default path never ran local BA")
    require(math.isfinite(run_d["ate"]) and run_d["ate"] <= 0.02,
            f"default path ATE {run_d['ate']} > 0.02")
    require_path_launches(launches_d, "default")
    require_pose_per_frame(launches_d, run_d["n_tracked_frames"], "default")
    run_d.pop("handler")

    # make_track_scan from a fresh handler's steady state, held against the
    # ground truth and against the handler run above over the same frames
    fresh = fh.FrameHandler(cam, cfg_d, device=dev)
    est_s, gt_s = [], []
    for i, img in enumerate(imgs_d[:SCAN_START]):
        res = fresh.add_image(img)
        if fresh.stage == fh.STAGE_DEFAULT_FRAME:
            t_wc = res.t_wc if res.t_wc is not None else res.T_cw.inverse().t
            est_s.append(t_wc.cpu().numpy().astype(np.float64))
            gt_s.append(poses_d[i].t.cpu().numpy().astype(np.float64))
    require(fresh.stage == 3, "fresh handler did not reach DEFAULT")
    window = torch.stack(imgs_d[SCAN_START:SCAN_START + SCAN_LEN])
    scan = pipeline.make_track_scan(cfg_d, cam, fresh.dims)
    _, outs = scan(fresh.vo, window)
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
        f"path (local BA between its frames) {d_scan:.2e}")
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
    cfg_lm = cfg.replace(poseoptim_method="lm", structureoptim_method="lm")
    run_lm, launches_lm, run_lm_p, dc_lm = run_with_plain(
        cfg_lm, cam, imgs, poses, dev, "lm")
    per_lm = {k: v / run_lm["n_tracked_frames"]
              for k, v in launches_lm.items()}
    log(f"lm path [{label}]: stage {run_lm['stage']}, tracked frames "
        f"{run_lm['n_tracked_frames']}, failures {run_lm['n_fail']}, "
        f"keyframes after bootstrap {run_lm['n_kf']}, ATE {run_lm['ate']:.6f} "
        f"(plain {run_lm_p['ate']:.6f})")
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
    run_e, launches_e, run_e_p, dc_e = run_with_plain(
        cfg_e, cam, imgs_e, poses_e, dev, "edgelets")
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
        f"{run_e_p['ate']:.6f})")
    log(f"launches on the edgelet path: {json.dumps(launches_e)}; per "
        f"tracked frame {json.dumps(per_e)}")
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

    # ---- 9. the dataset path at EuRoC MH_01 cam0's geometry ---------------
    build_dir = os.path.join(here, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        ds = dataset_phase(dev, label, workdir)

    # ---- 10. the batched multi-sequence step and the sharded paths, in a
    # process of its own (`--batched-phase OUT` also runs it alone)
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        out = os.path.join(workdir, "batched.json")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--batched-phase", out], cwd=here,
                            timeout=900).returncode
        require(rc == 0, f"phase 10 failed (rc {rc})")
        with open(out) as f:
            bt = json.load(f)

    # ---- 11. the last slice's public names on the card ---------------------
    sf = surface_phase(dev, label, ds["traj"])

    print(json.dumps({"gate": {"card": label, "checks": list(gate)}}),
          flush=True)
    print(json.dumps({"main_path": {
        "card": label, "ate": run_k["ate"], "ate_plain": run_p["ate"],
        "keyframes": run_k["n_kf"], "keyframes_plain": run_p["n_kf"],
        "centre_dev": dc, "launches": launches}}), flush=True)
    print(json.dumps({"default_path": {
        "card": label, "frames": N_ORBIT, "ate": run_d["ate"],
        "jax_ate_host": JAX_ATE_HOST, "keyframes": run_d["n_kf"],
        "local_ba_runs": run_d["n_local_ba"], "launches": launches_d,
        "scan_ate": ate_scan, "scan_twc_dev": d_scan}}), flush=True)
    print(json.dumps({"variants": {
        "card": label,
        "lm": {"ate": run_lm["ate"], "ate_plain": run_lm_p["ate"],
               "keyframes": run_lm["n_kf"], "centre_dev": dc_lm,
               "launches_per_frame": per_lm},
        "edgelets": {"frames": N_EDGE, "tracked": n_tr, "ate": run_e["ate"],
                     "ate_plain": run_e_p["ate"], "jax_ate_cpu": JAX_ATE_EDGE,
                     "keyframes": run_e["n_kf"],
                     "edgelet_landmarks": n_edge_pts,
                     "edgelet_seeds": n_edge_seeds, "centre_dev": dc_e,
                     "launches_per_frame": per_e}}}), flush=True)
    print(json.dumps({"dataset": {k: v for k, v in ds.items()
                                  if k != "traj"}}), flush=True)
    print(json.dumps({"batched": bt}), flush=True)
    print(json.dumps({"surface": sf}), flush=True)
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
