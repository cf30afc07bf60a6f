"""The 1D alignment the edgelet configuration runs on every seed and every
routed match: inverse-compositional Lucas-Kanade along a unit direction
(the edgelet's gradient, or the epipolar line) with a mean-brightness
term, written from SVO's `align1D` (`feature_alignment.cpp:35`) and the
program's calling conventions (`ops/matcher.py::align1d_stack`), in plain
torch and in any float dtype (float64 for the yardstick; bfloat16 image
data on float32 coordinates for the lower-precision control).  It samples
with the reference's own bilinear sampler (`patches.sample_stack`).

Departures from `feature_alignment.cpp:35`, each the program's own:

  - a fixed count of iterations, every row updated while it lies inside
    the level's margin: no stop on a small update and no step undone when
    the residual grows (SVO breaks there, and undoes the step along x and
    y as if it had been taken along x alone);
  - `converged` is the end position inside the margin (half + 1 pixels
    from each edge of the level) and a drift from the start shorter than
    the patch, not SVO's small final update;
  - the Hessian is regularised by 1e-6 I before it is inverted;
  - the patch is sampled on the padded pyramid stack at the row's level,
    the index clamped to its border, where SVO reads the level's image
    and stops at its edge;
  - the reference patch's gradients come in from the caller (central
    differences 0.5 (I(x+1) - I(x-1)) on the warped patch with its
    border, as SVO takes them); SVO's `h_inv` is not returned.
"""

from __future__ import annotations

import torch

from svo_bench.reference.patches import (_level_wh, _rows, patch_offsets,
                                         planes, sample_stack)

F64 = (torch.float64, torch.float64)
CONTROL = (torch.bfloat16, torch.float32)


def align1d(stack, lvl, ref_patch, ref_dx, ref_dy, direction, init_uv,
            valid, n_iter: int, h: int, w: int, dt=torch.float64,
            ct=torch.float64):
    """(uv (R, 2), converged (R,), mean (R,)) of the 1D alignment of each
    row's reference patch (R, P, P) with gradients ref_dx, ref_dy along
    its unit `direction` (R, 2), from `init_uv` at level `lvl` of the
    (L, Hp, Wp) stack, for `n_iter` iterations; image data in `dt`,
    coordinates in `ct`."""
    pl, plane, lv = planes(stack.to(dt), lvl, wrap=False)
    p = ref_patch.shape[-1]
    half, area = p // 2, p * p
    T = _rows(ref_patch, 2, dt).reshape(-1, area)
    gx = _rows(ref_dx, 2, dt).reshape(-1, area)
    gy = _rows(ref_dy, 2, dt).reshape(-1, area)
    d = _rows(direction, 1, ct)
    uv0 = _rows(init_uv, 1, ct)
    ok0 = valid.reshape(-1)
    n = uv0.shape[0]
    dd = d.to(dt)
    J = torch.stack([dd[:, 0:1] * gx + dd[:, 1:2] * gy,
                     torch.ones_like(gx)], dim=-1)           # (R, A, 2)
    H = torch.einsum("nai,naj->nij", J, J) + 1e-6 * torch.eye(
        2, dtype=dt, device=uv0.device)
    det = H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]
    hinv = torch.stack([torch.stack([H[:, 1, 1], -H[:, 0, 1]], -1),
                        torch.stack([-H[:, 1, 0], H[:, 0, 0]], -1)],
                       -2) / det[:, None, None]
    wl, hl = _level_wh(lv, h, w, ct)
    m = half + 1.0
    offs = patch_offsets(half, ct, uv0.device)

    def inb(uv):
        return ((uv[:, 0] >= m) & (uv[:, 0] < wl - 1 - m)
                & (uv[:, 1] >= m) & (uv[:, 1] < hl - 1 - m))

    uv = uv0
    mean = torch.zeros((n,), dtype=dt, device=uv0.device)
    for _ in range(n_iter):
        ok = ok0 & inb(uv)
        cur = sample_stack(pl, plane, uv[:, None, :] + offs[None])
        r = cur - T + mean[:, None]
        upd = torch.einsum("nij,nj->ni", hinv,
                           torch.einsum("nai,na->ni", J, r))
        uv = torch.where(ok[:, None], uv - upd[:, 0:1].to(ct) * d, uv)
        mean = torch.where(ok, mean - upd[:, 1], mean)
    drift = torch.linalg.norm(uv - uv0, dim=-1)
    return uv, ok0 & inb(uv) & (drift < p), mean


def gaps(got, ref, valid) -> dict:
    """The program's (uv, converged) against the reference's on the valid
    rows: the widest uv distance where both converge (level pixels) and
    the share of valid rows whose `converged` differs."""
    uv_got, conv_got = got[0].reshape(-1, 2), got[1].reshape(-1)
    uv_ref, conv_ref = ref[0].reshape(-1, 2), ref[1].reshape(-1)
    valid = valid.reshape(-1)
    both = conv_got & conv_ref & valid
    flips = int(((conv_got != conv_ref) & valid).sum())
    gap = 0.0
    if bool(both.any()):
        dist = torch.linalg.norm(uv_got.double() - uv_ref.double(), dim=-1)
        gap = float(dist[both].max())
    rows = int(valid.sum())
    return {"uv_gap_px": gap, "flip_share": flips / rows if rows else 0.0,
            "both": int(both.sum()), "rows": rows}
