"""The plain patch functions the tracking path calls, and the pyramid —
frozen from the port at 804481e (`ops/patch_kernels.py`: `_sample_plain`,
`_scan_plain`, `_align_plain`, `_align_mxu_plain` and their callers'
conventions; `ops/interp.py`: `bilinear_sample_stack`, `patch_offsets`;
`ops/pyramid.py`: `half_sample`, `stack_shape`).

Every function computes its image data in `dt` and its coordinates in `ct`
(float64 and float64 for the yardstick; bfloat16 data on float32
coordinates for the lower-precision control).  A call's rows may carry the
batch: a (B, L, Hp, Wp) stack with (B, N) rows reads plane b * L + level,
as the port's batched forms do.  The window ICLK samples the stack itself
where the port cuts a 32 x 64 window first: the two read the same pixels
wherever the loop may step (its bounds keep every patch inside the
window), which is where the outputs are compared.
"""

from __future__ import annotations

import torch

MIN_UPDATE_SQUARED = 0.03 * 0.03      # feature_alignment.cpp:276
WIN_R, WIN_C = 32, 64                 # the window ICLK's window


# ---------------------------------------------------------------------------
# the pyramid
# ---------------------------------------------------------------------------

def stack_shape(h: int, w: int, n_levels: int) -> tuple:
    """Rows to a multiple of 8 (at least 32), columns to a multiple of 128
    (at least 256)."""
    return (n_levels, max(-(-h // 8) * 8, 32), max(-(-w // 128) * 128, 256))


def build_stack(img: torch.Tensor, n_levels: int) -> torch.Tensor:
    """The zero-padded (L, Hp, Wp) stack of 2x2 block means, level l in the
    top-left (h >> l, w >> l) corner, in img's dtype."""
    h, w = img.shape
    _, hp, wp = stack_shape(h, w, n_levels)
    out = torch.zeros((n_levels, hp, wp), dtype=img.dtype, device=img.device)
    lev = img
    for lv in range(n_levels):
        out[lv, :lev.shape[0], :lev.shape[1]] = lev
        h2, w2 = lev.shape[0] // 2, lev.shape[1] // 2
        lev = lev[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2).mean(dim=(1, 3))
    return out


# ---------------------------------------------------------------------------
# rows and planes
# ---------------------------------------------------------------------------

def planes(stack: torch.Tensor, lvl: torch.Tensor, wrap: bool):
    """(planes (K, Hp, Wp), plane per row (R,), level per row (R,)) of a
    call: an (L, Hp, Wp) stack with (N,) rows, or a (B, L, Hp, Wp) stack
    with (B, N) rows.  The level counts from the end when negative where
    `wrap` (the sampler, the scan), and is clamped into [0, L)."""
    L = stack.shape[-3]
    lv = lvl.to(torch.int64)
    if wrap:
        lv = torch.where(lv < 0, lv + L, lv)
    lv = lv.clamp(0, L - 1)
    if stack.dim() == 3:
        return stack, lv.reshape(-1), lv.reshape(-1)
    B = stack.shape[0]
    base = torch.arange(B, device=lvl.device)[:, None] * L
    return (stack.reshape((B * L,) + stack.shape[-2:]),
            (base + lv).reshape(-1), lv.reshape(-1))


def patch_offsets(half: int, ct, device) -> torch.Tensor:
    """(P*P, 2) offsets of a (2 half)^2 patch, x fastest, top-left at
    -half."""
    r = torch.arange(2 * half, dtype=ct, device=device) - half
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def _index(xf: torch.Tensor, n: int):
    i0 = torch.nan_to_num(xf, nan=0.0).clamp(-1.0, float(n)).to(torch.int64)
    i0 = i0.clamp(0, n - 1)
    return i0, (i0 + 1).clamp(0, n - 1)


def sample_stack(imgs: torch.Tensor, plane: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of planes imgs (K, H, W) at plane (R,) and
    coordinates uv (R, ..., 2), the index clamped to the border; the
    weights in the planes' dtype."""
    k, h, w = imgs.shape
    x, y = uv[..., 0], uv[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0f).to(imgs.dtype), (y - y0f).to(imgs.dtype)
    x0, x1 = _index(x0f, w)
    y0, y1 = _index(y0f, h)
    ii = plane.reshape(plane.shape + (1,) * (uv.dim() - 2))
    return ((1 - wy) * ((1 - wx) * imgs[ii, y0, x0] + wx * imgs[ii, y0, x1])
            + wy * ((1 - wx) * imgs[ii, y1, x0] + wx * imgs[ii, y1, x1]))


def _rows(t: torch.Tensor, tail: int, dtype) -> torch.Tensor:
    """A (.., N, *tail) argument as (R, *tail) rows in dtype."""
    shape = t.shape[t.dim() - tail:] if tail else ()
    return t.reshape((-1,) + tuple(shape)).to(dtype)


def _nan0(t):
    return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)


# ---------------------------------------------------------------------------
# sample_patches
# ---------------------------------------------------------------------------

def sample_patches(stack, lvl, uv, half: int, grad: bool = False,
                   dt=torch.float64, ct=torch.float64):
    """(R, P, P) bilinear patches, or the (patch, dx, dy) triple with
    central differences 0.5 (I(x+1) - I(x-1)), at each row's plane."""
    pl, plane, _ = planes(stack.to(dt), lvl, wrap=True)
    p = 2 * half
    uvr = _rows(uv, 1, ct)
    n = uvr.shape[0]
    coords = uvr[:, None, :] + patch_offsets(half, ct, uvr.device)[None]
    val = sample_stack(pl, plane, coords).reshape(n, p, p)
    if not grad:
        return val
    ex = torch.tensor([1.0, 0.0], dtype=ct, device=uvr.device)
    ey = torch.tensor([0.0, 1.0], dtype=ct, device=uvr.device)
    dx = 0.5 * (sample_stack(pl, plane, coords + ex)
                - sample_stack(pl, plane, coords - ex))
    dy = 0.5 * (sample_stack(pl, plane, coords + ey)
                - sample_stack(pl, plane, coords - ey))
    return val, dx.reshape(n, p, p), dy.reshape(n, p, p)


# ---------------------------------------------------------------------------
# epi_scan
# ---------------------------------------------------------------------------

def _level_wh(lv, h: int, w: int, ct):
    return (w >> lv).to(ct), (h >> lv).to(ct)


def _scan_scores(pl, plane, lv, uv_a, uv_b, ref_zm, ts, live, half, h, w):
    """Scores (R, K) of the positions ts (R, K) on each segment: the ZMSSD
    of the centred patch against the centred reference, +inf off the
    level's margin (half + 2) or where not `live`."""
    p = 2 * half
    uvk = uv_a[:, None, :] * (1 - ts[..., None]) + uv_b[:, None, :] * ts[..., None]
    coords = uvk[:, :, None, :] + patch_offsets(half, ts.dtype, ts.device)
    cur = sample_stack(pl, plane, coords)                 # (R, K, P*P)
    cur = cur - cur.mean(dim=-1, keepdim=True)
    d = cur - ref_zm.reshape(-1, 1, p * p)
    score = torch.sum(d * d, dim=-1)
    wl, hl = _level_wh(lv, h, w, ts.dtype)
    m = half + 2.0
    inb = ((uvk[..., 0] >= m) & (uvk[..., 0] < wl[:, None] - 1 - m)
           & (uvk[..., 1] >= m) & (uvk[..., 1] < hl[:, None] - 1 - m))
    return torch.where(inb & live, score, torch.full_like(score, float("inf")))


def _scan_rows(stack, lvl, uv_a, uv_b, ref_patch, dt, ct):
    pl, plane, lv = planes(stack.to(dt), lvl, wrap=True)
    p = ref_patch.shape[-1]
    rp = _rows(ref_patch, 2, dt).reshape(-1, p * p)
    rp = rp - rp.mean(dim=-1, keepdim=True)
    return (pl, plane, lv, _rows(_nan0(uv_a), 1, ct),
            _rows(_nan0(uv_b), 1, ct), rp)


def epi_scan(stack, lvl, uv_a, uv_b, ref_patch, n_steps_max: int, half: int,
             n_steps_each, h: int, w: int, dt=torch.float64,
             ct=torch.float64, block: int = 2048):
    """(best t, best score) per row: the first minimum over
    `n_steps_each` (None: n_steps_max) uniform positions from uv_a to
    uv_b; (0, +inf) where none is in bounds."""
    pl, plane, lv, a, b, rp = _scan_rows(stack, lvl, uv_a, uv_b, ref_patch,
                                         dt, ct)
    n = a.shape[0]
    if n_steps_each is None:
        k = torch.full((n,), n_steps_max, dtype=torch.int64, device=a.device)
    else:
        k = n_steps_each.reshape(-1).to(torch.int64)
    k = k.clamp(0, n_steps_max)
    js = torch.arange(n_steps_max, dtype=ct, device=a.device)
    best_t, best_s = [], []
    for i in range(0, n, block):
        s = slice(i, i + block)
        ts = torch.clamp(js[None] / torch.clamp(k[s] - 1, min=1)[:, None].to(ct),
                         max=1.0)
        live = js[None] < k[s][:, None].to(ct)
        sc = _scan_scores(pl, plane[s], lv[s], a[s], b[s], rp[s], ts, live,
                          half, h, w)
        j = torch.argmin(sc, dim=-1)
        best_t.append(torch.gather(ts, 1, j[:, None])[:, 0])
        best_s.append(torch.gather(sc, 1, j[:, None])[:, 0])
    return torch.cat(best_t), torch.cat(best_s)


def epi_scan_score_at(stack, lvl, uv_a, uv_b, ref_patch, t, half: int,
                      h: int, w: int, dt=torch.float64, ct=torch.float64):
    """The score of position t (R,) on each segment, as `epi_scan` scores
    its positions."""
    pl, plane, lv, a, b, rp = _scan_rows(stack, lvl, uv_a, uv_b, ref_patch,
                                         dt, ct)
    ts = t.reshape(-1, 1).to(ct)
    live = torch.ones_like(ts, dtype=torch.bool)
    return _scan_scores(pl, plane, lv, a, b, rp, ts, live, half, h, w)[:, 0]


# ---------------------------------------------------------------------------
# the ICLK alignments
# ---------------------------------------------------------------------------

def inv3(H: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3), in H's dtype."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    inv = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return inv / det[..., None, None]


def align_iclk(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
               n_iter: int, h: int, w: int, window: bool = False,
               zmssd_factor=None, min_patch_std=None, updates=None,
               dt=torch.float64, ct=torch.float64):
    """2D inverse-compositional LK with a mean-brightness term, each row
    frozen once done (a fixed-count loop): `align_iclk` (window False) or
    `align_iclk_mxu` (window True: the start's NaNs read as 0, the steps
    also held inside the 32 x 64 window around the start, the ZMSSD and
    std gates folded into `converged`).  Returns (uv (R, 2), converged
    (R,), mean (R,)); `updates` (a list) gets each iteration's count of
    rows updated."""
    pl, plane, lv = planes(stack.to(dt), lvl, wrap=False)
    p = ref_patch.shape[-1]
    half, area = p // 2, p * p
    T = _rows(ref_patch, 2, dt).reshape(-1, area)
    gx = _rows(ref_dx, 2, dt).reshape(-1, area)
    gy = _rows(ref_dy, 2, dt).reshape(-1, area)
    uv0 = _rows(init_uv, 1, ct)
    if window:
        uv0 = _nan0(uv0)
    ok0 = valid.reshape(-1)
    n = uv0.shape[0]
    J = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)    # (R, A, 3)
    H = torch.einsum("nai,naj->nij", J, J) + 1e-6 * torch.eye(
        3, dtype=dt, device=uv0.device)
    hinv = inv3(H)
    wl, hl = _level_wh(lv, h, w, ct)
    Hp, Wp = pl.shape[-2:]
    org = torch.stack([
        torch.clamp(torch.floor(uv0[:, 0]) - WIN_C // 2, 0, Wp - (WIN_C + 1)),
        torch.clamp(torch.floor(uv0[:, 1]) - WIN_R // 2, 0, Hp - (WIN_R + 1))],
        dim=-1)
    m, wb = half + 1.0, half + 2.0
    offs = patch_offsets(half, ct, uv0.device)

    def inb(uv):
        ok = ((uv[:, 0] >= m) & (uv[:, 0] < wl - 1 - m)
              & (uv[:, 1] >= m) & (uv[:, 1] < hl - 1 - m))
        if window:
            d = uv - org
            ok = ok & ((d[:, 0] >= wb) & (d[:, 0] < WIN_C - 1 - wb)
                       & (d[:, 1] >= wb) & (d[:, 1] < WIN_R - 1 - wb))
        return ok

    def step(uv, mean):
        cur = sample_stack(pl, plane, uv[:, None, :] + offs[None])
        r = cur - T + mean[:, None]
        g = torch.einsum("nai,na->ni", J, r)
        return torch.einsum("nij,nj->ni", hinv, g), cur

    uv = uv0
    mean = torch.zeros((n,), dtype=dt, device=uv0.device)
    done = torch.zeros((n,), dtype=torch.bool, device=uv0.device)
    for _ in range(n_iter):
        ok = ok0 & inb(uv) & ~done
        if updates is not None:
            updates.append(int(ok.sum()))
        upd, _ = step(uv, mean)
        uv = torch.where(ok[:, None], uv - upd[:, :2].to(ct), uv)
        mean = torch.where(ok, mean - upd[:, 2], mean)
        step2 = torch.sum(upd[:, :2].to(ct) ** 2, dim=-1)
        done = done | ~inb(uv) | (step2 < MIN_UPDATE_SQUARED)
    ok = ok0 & inb(uv)
    upd, cur = step(uv, mean)
    step2 = torch.where(ok, torch.sum(upd[:, :2].to(ct) ** 2, dim=-1),
                        torch.full((n,), float("inf"), dtype=ct,
                                   device=uv0.device))
    drift = torch.linalg.norm(uv - uv0, dim=-1)
    conv = ok0 & (step2 < 4.0 * MIN_UPDATE_SQUARED) & (drift < p)
    if zmssd_factor is not None:
        rz = T - T.mean(dim=-1, keepdim=True)
        cz = cur - cur.mean(dim=-1, keepdim=True)
        conv = conv & (torch.sum((cz - rz) ** 2, dim=-1) < zmssd_factor * area)
    if min_patch_std is not None:
        conv = conv & (cur.std(dim=-1, correction=0) >= min_patch_std)
    return uv, conv, mean
