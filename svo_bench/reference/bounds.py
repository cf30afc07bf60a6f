"""A patch function's least time on one H100 from the call's own
arguments — frozen from `chip_smoke.py::bound`, `scan_bound` and
`kernel_bounds` and `ops/patch_kernels.py::count_iclk_updates` at 804481e,
written for any patch size and for the batched forms' (B, N) rows.

Bytes: every input byte read once (of the image, only the distinct pixels
the live rows' footprints touch, at most the planes they read), every
output byte written once.  Operations: the float32 work these inputs need
(bilinear sample ~11 flops a pixel; the scan's scored positions ~15 a
pixel and ~10 for each position only placed; the ICLK updates the loop
makes before each row freezes, counted by the plain loop).  The least time
is the larger of bytes over the HBM peak and operations over the float32
peak, so it holds whatever implements the function.
"""

from __future__ import annotations

import torch

from svo_bench.reference import patches

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def least_seconds(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def _live(a: dict) -> torch.Tensor:
    """Rows that do work: valid (where the call has a mask) and with a
    finite position."""
    uv = a.get("uv", a.get("init_uv", a.get("uv_a")))
    ok = torch.isfinite(uv.reshape(-1, 2)).all(-1)
    if a.get("valid") is not None:
        ok = ok & a["valid"].reshape(-1).to(torch.bool)
    return ok


def _footprint_bytes(stack, lvl, n_live: int, side: int, wrap: bool) -> int:
    """Bytes of n_live square footprints of `side` pixels, at most the
    bytes of the distinct planes the rows read."""
    _, plane, _ = patches.planes(stack, lvl, wrap)
    plane_px = stack.shape[-2] * stack.shape[-1]
    n_planes = int(torch.unique(plane).numel()) if plane.numel() else 0
    return min(n_live * side * side * 4, n_planes * plane_px * 4)


def sample_patches(a: dict) -> tuple:
    """(bytes, flops) of a sample_patches call: (2 half)^2 patches, with
    gradients a (2 half + 2)^2 grid of samples and three outputs."""
    half, grad = int(a["half"]), bool(a.get("grad", False))
    p = 2 * half
    n = a["lvl"].numel()
    live = int(_live(a).sum())
    side = p + 3 if grad else p + 1
    reads = (_footprint_bytes(a["stack"], a["lvl"], live, side, True)
             + n * (4 + 8 + (1 if a.get("valid") is not None else 0)))
    writes = (3 if grad else 1) * n * p * p * 4
    flops = live * ((p + 2) ** 2 * 11 + p * p * 4 if grad else p * p * 11)
    return reads + writes, flops


def epi_scan(a: dict) -> tuple:
    """(bytes, flops) of an epi_scan call: the distinct pixels the scored
    positions' (P + 1)^2 footprints touch, the inputs and outputs once."""
    stack, lvl = a["stack"], a["lvl"]
    half, kmax = int(a["half"]), int(a["n_steps_max"])
    p = 2 * half
    h, w = int(a["h"]), int(a["w"])
    pl, plane, lv = patches.planes(stack, lvl, wrap=True)
    ua = patches._rows(patches._nan0(a["uv_a"]), 1, torch.float32)
    ub = patches._rows(patches._nan0(a["uv_b"]), 1, torch.float32)
    n = ua.shape[0]
    if a.get("n_steps_each") is None:
        k = torch.full((n,), kmax, dtype=torch.int64, device=ua.device)
    else:
        k = a["n_steps_each"].reshape(-1).to(torch.int64)
    k = k.clamp(0, kmax)
    j = torch.arange(kmax, device=ua.device)
    t = torch.clamp(j[None] / torch.clamp(k - 1, min=1)[:, None], max=1.0)
    pos = ua[:, None] * (1 - t[..., None]) + ub[:, None] * t[..., None]
    wl = (w >> lv).float()[:, None]
    hl = (h >> lv).float()[:, None]
    m = half + 2.0
    scored = ((j[None] < k[:, None]) & (pos[..., 0] >= m)
              & (pos[..., 0] < wl - 1 - m) & (pos[..., 1] >= m)
              & (pos[..., 1] < hl - 1 - m))
    _, hp, wp = pl.shape
    seen = torch.zeros(pl.shape[0] * hp * wp, dtype=torch.bool,
                       device=ua.device)
    r = torch.arange(p + 1, device=ua.device)
    pl_idx = plane[:, None].expand(n, kmax)[scored]
    corner = torch.floor(pos[scored]).long() - half
    for i in range(0, corner.shape[0], 1 << 16):
        c, q = corner[i:i + (1 << 16)], pl_idx[i:i + (1 << 16)]
        rows = (c[:, None, None, 1] + r[None, :, None]).clamp(0, hp - 1)
        cols = (c[:, None, None, 0] + r[None, None, :]).clamp(0, wp - 1)
        seen[((q[:, None, None] * hp + rows) * wp + cols).reshape(-1)] = True
    n_scored = int(scored.sum())
    bytes_moved = (int(seen.sum()) * 4 + n * (p * p * 4 + 16 + 4 + 4)
                   + n * 8)
    flops = n_scored * p * p * 15 + int(k.sum()) * 10 + n * p * p * 2
    return bytes_moved, flops


def iclk_updates(a: dict, window: bool) -> int:
    """Row updates the ICLK loop makes on these inputs before each row
    freezes, counted by the plain loop in float32."""
    counts: list = []
    patches.align_iclk(
        a["stack"], a["lvl"], a["ref_patch"], a["ref_dx"], a["ref_dy"],
        a["init_uv"], a["valid"], int(a["n_iter"]), int(a["h"]),
        int(a["w"]), window=window, updates=counts, dt=torch.float32,
        ct=torch.float32)
    return sum(counts)


def align_iclk(a: dict, window: bool = False) -> tuple:
    """(bytes, flops) of an align_iclk (window False) or align_iclk_mxu
    call: the live rows' footprints with the +-2 px start offset, the
    template, both gradients and the start read once, uv, mean and
    converged written once; each update ~19 flops a template pixel and the
    final probe once more, the Hessian and its inverse, and the window
    kernel's gates ~9 flops a pixel."""
    p = a["ref_patch"].shape[-1]
    area = p * p
    n = a["lvl"].numel()
    live = int(_live(a).sum())
    foot = _footprint_bytes(a["stack"], a["lvl"], live, p + 5, False)
    evals = iclk_updates(a, window) + n
    flops = evals * (area * 19 + 15) + n * (area * 8 + 60)
    if window and (a.get("zmssd_factor") is not None
                   or a.get("min_patch_std") is not None):
        flops += n * area * 9
    return foot + n * (3 * area * 4 + 4 + 8 + 1) + n * 13, flops


BOUNDS = {
    "sample_patches": sample_patches,
    "epi_scan": epi_scan,
    "align_iclk": lambda a: align_iclk(a, window=False),
    "align_iclk_mxu": lambda a: align_iclk(a, window=True),
}


def call_seconds(kind: str, args: dict) -> float:
    """The least time of one call of the patch function `kind`."""
    return least_seconds(*BOUNDS[kind](args))
