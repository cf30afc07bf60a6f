"""Relocalization demonstration on the card — the port of
`scripts/reloc_demo.py`:

    python -m android_svo_tpu_torch.tools.reloc_demo [--frames 34]
        [--occlude 18 4] [--trace PATH]

The tracker runs `SVOConfig(init_min_disparity=20.0, max_n_kfs=8)` (local BA
on) over a 640x480 sweep whose frames 18-21 are blank.  The match
information floor fails the blank frames honestly, the two-strike policy
flips the handler to RELOCALIZING, and when texture returns it must
re-acquire through sparse alignment against the closest keyframe.  Each
frame's stage, result and match count is printed, the per-frame trace goes
to `--trace` (JSONL, `utils/profiling.PerformanceMonitor`), and a one-line
JSON summary ends the output; the exit code is 1 unless tracking was lost
and recovered and the final stage is DEFAULT.  Runs on CUDA; raises without
a card.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import pipeline
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.evals.trajectory import ate_rmse
from android_svo_tpu_torch.utils.profiling import PerformanceMonitor

DEFAULT_TRACE = str(Path(__file__).resolve().parents[2] / "build"
                    / "reloc_trace.jsonl")


def probe_dispatch_ms(device, n=20) -> float:
    """Median host time of one trivial op plus synchronisation."""
    x = torch.ones((256, 256), device=device)

    def once():
        y = x * 2.0
        if y.is_cuda:
            torch.cuda.synchronize(device)
        return y

    once()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        once()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[n // 2] * 1e3


def sweep_poses(frames, device):
    """scripts/reloc_demo.py's pose sweep: a steady diagonal sweep over the
    textured plane, pitched 0.45 rad."""
    return [synthetic.lookdown_pose(
        0.12 * i, 0.02 * i, -3.0,
        (0.45 + 0.0008 * i, -0.0008 * i, 0.001 * i), device=device)
        for i in range(frames)]


def run(frames=34, occlude=(18, 4), width=640, height=480,
        trace=DEFAULT_TRACE, device=None, log=print) -> dict:
    dev = resolve_device(device)
    dispatch0 = probe_dispatch_ms(dev)
    log(f"# dev={dev} dispatch_ms={dispatch0:.3f}")
    occ0, occn = occlude
    occluded = set(range(occ0, occ0 + occn))
    cfg = SVOConfig(init_min_disparity=20.0, max_n_kfs=8)
    cam = synthetic.default_camera(width, height, device=dev)
    tex = synthetic.make_texture(torch.Generator().manual_seed(0), 2048,
                                 device=dev)
    poses = sweep_poses(frames, dev)
    imgs = [synthetic.render(tex, cam, p) for p in poses]
    blank = torch.zeros_like(imgs[0])
    imgs = [blank if i in occluded else im for i, im in enumerate(imgs)]

    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
    pm = PerformanceMonitor(trace_path=trace)
    handler = fh.FrameHandler(cam, cfg, perf_mon=pm, device=dev)
    saw_reloc_at = recovered_at = None
    est, gt = [], []
    try:
        for i in range(frames):
            res = handler.add_image(imgs[i], i * 0.05)
            stage = handler.stage
            if stage == fh.STAGE_RELOCALIZING and saw_reloc_at is None:
                saw_reloc_at = i
            if (saw_reloc_at is not None and recovered_at is None
                    and stage == fh.STAGE_DEFAULT_FRAME):
                recovered_at = i
            if (stage == fh.STAGE_DEFAULT_FRAME and i not in occluded
                    and res.result != pipeline.RES_FAILURE
                    and res.t_wc is not None):
                t_est = res.t_wc.detach().cpu().numpy().astype(np.float64)
                if np.isfinite(t_est).all():
                    est.append(t_est)
                    gt.append(poses[i].t.detach().cpu().numpy().astype(
                        np.float64))
            log(f"frame {i:3d} stage={stage} res={res.result} "
                f"matches={res.n_matches}"
                f"{' OCCLUDED' if i in occluded else ''}")
    finally:
        pm.close()

    ate = ate_rmse(np.array(est), np.array(gt)) if len(est) >= 4 else -1.0
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "occluded_frames": sorted(occluded),
        "reloc_entered_at": saw_reloc_at,
        "recovered_at": recovered_at,
        "frames_to_recover": (None if recovered_at is None
                              or saw_reloc_at is None
                              else recovered_at - (occ0 + occn - 1)),
        "final_stage": int(handler.stage),
        "ate": round(float(ate), 5),
        "dispatch_ms_start": round(dispatch0, 3),
        "dispatch_ms_end": round(probe_dispatch_ms(dev), 3),
        "trace": trace,
        "local_ba_runs": handler.n_local_ba,
        "ok": bool(saw_reloc_at is not None and recovered_at is not None
                   and handler.stage == fh.STAGE_DEFAULT_FRAME),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=34)
    ap.add_argument("--occlude", type=int, nargs=2, default=(18, 4),
                    metavar=("START", "LEN"))
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--trace", default=DEFAULT_TRACE)
    args = ap.parse_args(argv)
    out = run(args.frames, tuple(args.occlude), args.width, args.height,
              args.trace, log=lambda m: print(m, flush=True))
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
