"""The comparison that decides `correct`.

After the window has closed, the numbers below are taken from what the
timed path produced and held to the cell's limits (`limits/<cell>.json`):

  failures         frames (sequence-frames) that returned RES_FAILURE or no
                   pose; limit 0
  ate_m            the configuration's stated accuracy: the ATE (Umeyama
                   Sim(3), `reference/trajectory.py`) against the path the
                   frames were rendered from, over every 120-frame stretch
                   of the window (the scan over which bench.py states ATE
                   <= 0.02), each stretch aligned by its own similarity,
                   the worst stretch of the worst sequence; limit 0.02
  pose_gap_px      the motion-only bundle adjustment of every frame
                   (sequence-frame) of the window's first `pose_units`
                   units: each frame's widest distance, in pixels, between
                   a valid point's projections under the program's refined
                   pose and the reference's (`reference/pose.py`,
                   float64), run from the same starting pose, points and
                   bearings; the root mean square over the frames (a
                   Gauss-Newton step kept on one side and refused on the
                   other by rounding leaves a rare frame a tenth of a
                   pixel apart: PERF.md)
  stack_gap        the pyramid stacks of the sampled frames against the
                   reference's pyramid of the 8-bit frame the benchmark
                   made: the start of the tracking step (decode, copy and
                   pyramid); exact, limit 0
  sample_gap       sample_patches' patches (and gradients) on the live rows
                   against the reference, intensity units
  scan_gap         epi_scan: how far the reference's score at the position
                   the program chose lies above the reference's best,
                   relative to that best plus one intensity unit squared a
                   pixel, widest over the seeds both find in bounds
  iclk_uv_gap_px   align_iclk and align_iclk_mxu: the widest distance
                   between the program's and the reference's uv where both
                   converged, level pixels
  iclk_flip_share  rows whose `converged` differs, over the valid rows

`scan_flip_share` (seeds where one side finds a position in bounds and the
other none) is logged, not compared: neither sound runs nor the control
ever read it above 0, so no limit between them exists.

The kernel numbers cover every call of the four patch functions on the
frames (steps) sampled from the seed, at the window's shapes: the reference
(`reference/patches.py`, float64) follows the program from its own inputs
to each call, and the stack check covers the start by itself.
`pose_gap_px` follows the program in the same way from the inputs of its
pose refinement (the points come from the program's map); `ate_m` holds
the poses themselves against the truth.  The control is the same reference
in the program's place one precision down (`control_numbers`): bfloat16
image data on float32 coordinates for the patch functions, which have no
matrix product for TF32 to round, and TF32 products for the pose
refinement.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from svo_bench.reference import patches, pose, trajectory

F64 = (torch.float64, torch.float64)
CONTROL = (torch.bfloat16, torch.float32)


def load_limits(cell: str, bench_dir: Path) -> dict:
    """The cell's limits, `limits/<cell>.json` in the benchmark's folder."""
    with open(Path(bench_dir) / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def _dims(a: dict) -> tuple:
    h = a.get("h") if a.get("h") is not None else a["stack"].shape[-2]
    w = a.get("w") if a.get("w") is not None else a["stack"].shape[-1]
    return int(h), int(w)


def reference_call(kind: str, a: dict, prec=F64):
    """The reference's outputs for one call of the patch function `kind`
    with arguments `a`, at precision `prec` (data dtype, coordinate
    dtype), shaped as the program's rows."""
    dt, ct = prec
    if kind == "sample_patches":
        return patches.sample_patches(a["stack"], a["lvl"], a["uv"],
                                      int(a["half"]), bool(a["grad"]), dt, ct)
    h, w = _dims(a)
    if kind == "epi_scan":
        return patches.epi_scan(a["stack"], a["lvl"], a["uv_a"], a["uv_b"],
                                a["ref_patch"], int(a["n_steps_max"]),
                                int(a["half"]), a["n_steps_each"], h, w,
                                dt, ct)
    window = kind == "align_iclk_mxu"
    return patches.align_iclk(
        a["stack"], a["lvl"], a["ref_patch"], a["ref_dx"], a["ref_dy"],
        a["init_uv"], a["valid"], int(a["n_iter"]), h, w, window=window,
        zmssd_factor=a.get("zmssd_factor") if window else None,
        min_patch_std=a.get("min_patch_std") if window else None,
        dt=dt, ct=ct)


def _live(a: dict) -> torch.Tensor:
    ok = torch.isfinite(a["uv"].reshape(-1, 2)).all(-1)
    if a.get("valid") is not None:
        ok = ok & a["valid"].reshape(-1)
    return ok


def judge_call(kind: str, a: dict, got, ref) -> dict:
    """Gaps of the outputs `got` of one call against the reference's
    `ref`: {number: (value, rows)} for the numbers this kind feeds."""
    if kind == "sample_patches":
        live = _live(a)
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        gap = 0.0
        for g, r in zip(got, ref):
            g = g.reshape(live.shape[0], -1)[live].double()
            r = r.reshape(live.shape[0], -1)[live].double()
            if g.numel():
                gap = max(gap, float((g - r).abs().max()))
        return {"sample_gap": (gap, int(live.sum()))}
    if kind == "epi_scan":
        t_got, s_got = (o.reshape(-1) for o in got)
        t_ref, s_ref = ref
        fin_got, fin_ref = torch.isfinite(s_got), torch.isfinite(s_ref)
        flips = int((fin_got != fin_ref).sum())
        both = fin_got & fin_ref
        gap = 0.0
        if bool(both.any()):
            h, w = _dims(a)
            at = patches.epi_scan_score_at(
                a["stack"], a["lvl"], a["uv_a"], a["uv_b"], a["ref_patch"],
                t_got, int(a["half"]), h, w)
            # the score at the program's position, in bounds or not (a
            # position on the margin may round either way)
            unmasked = _unmasked_scores(a, t_got)
            at = torch.where(torch.isfinite(at), at, unmasked)
            p2 = a["ref_patch"].shape[-1] ** 2
            rel = (at - s_ref.double()) / (s_ref.double() + p2)
            gap = float(rel[both].max())
        return {"scan_gap": (gap, int(both.sum())),
                "scan_flip_share": (flips, int(s_ref.numel()))}
    uv_got, conv_got, _ = got
    uv_ref, conv_ref, _ = ref
    valid = a["valid"].reshape(-1)
    cg, cr = conv_got.reshape(-1), conv_ref.reshape(-1)
    flips = int(((cg != cr) & valid).sum())
    both = cg & cr & valid
    gap = 0.0
    if bool(both.any()):
        d = uv_got.reshape(-1, 2).double() - uv_ref.double()
        gap = float(torch.linalg.norm(d[both], dim=-1).max())
    return {"iclk_uv_gap_px": (gap, int(both.sum())),
            "iclk_flip_share": (flips, int(valid.sum()))}


def _unmasked_scores(a: dict, t: torch.Tensor) -> torch.Tensor:
    """The scores at t with no margin test (level dims far out)."""
    return patches.epi_scan_score_at(a["stack"], a["lvl"], a["uv_a"],
                                     a["uv_b"], a["ref_patch"], t,
                                     int(a["half"]), 1 << 20, 1 << 20)


SHARES = ("scan_flip_share", "iclk_flip_share")


def fold(parts: list) -> dict:
    """The per-call gaps folded into one number each: the widest gap, and
    for a share the count over the rows."""
    out, counts = {}, {}
    for part in parts:
        for name, (value, rows) in part.items():
            if name in SHARES:
                c = counts.setdefault(name, [0, 0])
                c[0] += value
                c[1] += rows
            else:
                out[name] = max(out.get(name, 0.0), value)
    for name, (flips, rows) in counts.items():
        out[name] = flips / rows if rows else 0.0
    return out


def stack_gap(stacks: list, frames: list) -> float:
    """Widest gap between the program's pyramid stacks and the reference's
    pyramid of the same 8-bit frames."""
    gap = 0.0
    for stack, frame in zip(stacks, frames):
        ref = patches.build_stack(frame.to(stack.device, torch.float64),
                                  stack.shape[-3])
        gap = max(gap, float((stack.double() - ref.double()).abs().max()))
    return gap


def kernel_numbers(calls: list, control: bool = False) -> dict:
    """The kernel numbers over the captured calls [(kind, args, outputs)];
    with `control` the judged outputs are the reference's own at the
    control's precision, not the program's."""
    parts = []
    for kind, a, got in calls:
        ref = reference_call(kind, a)
        if control:
            got = reference_call(kind, a, CONTROL)
        parts.append(judge_call(kind, a, got, ref))
    return fold(parts)


def control_numbers(calls: list, stacks: list) -> dict:
    """The control's readings of the stack and kernel numbers: the
    reference's pyramid and patch functions at the control's precision in
    the program's place, judged as the program is."""
    gap = 0.0
    for ss, frames in stacks:
        ctl = [patches.build_stack(f.to(s.device, CONTROL[0]), s.shape[-3])
               for s, f in zip(ss, frames)]
        gap = max(gap, stack_gap(ctl, frames))
    return {"stack_gap": gap, **kernel_numbers(calls, control=True)}


def pose_control(calls: list) -> dict:
    gaps = pose_gaps(calls, control=True)
    return {"pose_gap_px": rms(gaps), "pose_gap_px_widest": max(gaps)}


STRETCH = 120         # frames of a stretch of `ate_m` (bench.py's scan)


def pose_numbers(est: list, gt: list) -> dict:
    """One sequence's `ate_m` (compared) and, for the log, the window's
    ATE under one similarity and each stretch's ATE and scale."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    parts = trajectory.stretch_ates(est, gt, STRETCH)
    return {"ate_m": max((a for a, _ in parts), default=float("inf")),
            "window_ate_m": trajectory.ate_rmse(est, gt),
            "stretch_ate_m": [round(a, 6) for a, _ in parts],
            "stretch_scale": [round(s, 4) for _, s in parts]}


def _pose_focal(rec: dict) -> float:
    return float(torch.as_tensor(rec["focal"]).reshape(-1)[0])


def pose_gaps(calls: list, control: bool = False) -> list:
    """Each captured refinement's widest projection gap (px) between the
    program's pose and the reference's; with `control` the judged pose is
    the reference's own with TF32 products, not the program's."""
    gaps = []
    for r in calls:
        if r["method"] != "gn":
            raise ValueError(f"no reference for pose method {r['method']!r}")
        focal = _pose_focal(r)
        args = (r["q0"], r["t0"], r["p_w"], r["f_meas"], r["level"],
                r["valid"], focal, r["n_iter"])
        q_ref, t_ref = pose.optimize_pose(*args)
        q, t = r["q"], r["t"]
        if control:
            q, t = pose.optimize_pose(*args, dtype=torch.float32, low=True)
        gaps.append(pose.pose_gap_px(q, t, q_ref, t_ref, r["p_w"],
                                     r["valid"], focal))
    return gaps


def rms(values: list) -> float:
    return math.sqrt(sum(v * v for v in values) / len(values)) if values \
        else float("nan")


def pose_gap(calls: list, control: bool = False) -> float:
    """`pose_gap_px`: the root mean square of `pose_gaps`."""
    return rms(pose_gaps(calls, control))


def decide(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is not finite, or one that is missing, fails."""
    compared, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        finite = isinstance(value, (int, float)) and math.isfinite(value)
        ok = ok and finite and value <= limit
        # strict JSON has no NaN or infinity: such a number reads null
        compared[name] = {"value": value if finite else None, "limit": limit}
    return ok, compared
