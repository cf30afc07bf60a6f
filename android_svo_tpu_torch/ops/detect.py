"""Feature detection: dense Shi-Tomasi + vectorized FAST with one corner per
grid cell, and (with `cfg.edgelet_detection`) the strongest-gradient
EDGELET in cells with no corner — port of `android_svo_tpu/ops/detect.py`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from android_svo_tpu_torch.config import SVOConfig

FAST_RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
EDGE_MARGIN = 8

FTYPE_CORNER = 0
FTYPE_EDGELET = 1


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box filter (same-size, zero pad): output i sums inputs
    i - size/2 .. i + size/2 - 1 along each axis, the JAX package's window
    (its cumulative-sum differences).  Summed as `size` shifted slices in a
    fixed order: on CUDA a cumulative sum rounds differently with a leading
    batch (`torch.func.vmap`), slices do not."""
    half = size // 2
    for dim in (-2, -1):
        n = x.shape[dim]
        pad = [0, 0, 0, 0]
        # F.pad lists the last dim first
        if dim == -1:
            pad[0], pad[1] = half + 1, half
        else:
            pad[2], pad[3] = half + 1, half
        xp = F.pad(x, pad)
        acc = xp.narrow(dim, 1, n)
        for j in range(2, size + 1):
            acc = acc + xp.narrow(dim, j, n)
        x = acc
    return x


def _central_diff(img: torch.Tensor):
    dx = torch.zeros_like(img)
    dx[:, 1:-1] = img[:, 2:] - img[:, :-2]
    dy = torch.zeros_like(img)
    dy[1:-1, :] = img[2:, :] - img[:-2, :]
    return dx, dy


def shi_tomasi_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense min-eigenvalue corner score (8x8 box, 1/(2*box_area))."""
    dx, dy = _central_diff(img)
    box = 8
    dxx = _box_sum(dx * dx, box) / (2.0 * box * box)
    dyy = _box_sum(dy * dy, box) / (2.0 * box * box)
    dxy = _box_sum(dx * dy, box) / (2.0 * box * box)
    tr = dxx + dyy
    det_term = torch.sqrt(torch.clamp(tr * tr - 4.0 * (dxx * dyy - dxy * dxy),
                                      min=0.0))
    return 0.5 * (tr - det_term)


def fast_corner_mask(img: torch.Tensor, thresh: float) -> torch.Tensor:
    """FAST-9/16 segment test on 16 ring-shifted copies; 3-px border off."""
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for dx, dy in FAST_RING], dim=0)
    bright = ring > img[None] + thresh
    dark = ring < img[None] - thresh

    def has_run9(m):
        r2 = m & torch.roll(m, -1, dims=0)
        r4 = r2 & torch.roll(r2, -2, dims=0)
        r8 = r4 & torch.roll(r4, -4, dims=0)
        r9 = r8 & torch.roll(m, -8, dims=0)
        return torch.any(r9, dim=0)

    corner = has_run9(bright) | has_run9(dark)
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    border_ok = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return corner & border_ok


def _mask_margin(score: torch.Tensor, margin: int) -> torch.Tensor:
    h, w = score.shape
    yy = torch.arange(h, device=score.device)[:, None]
    xx = torch.arange(w, device=score.device)[None, :]
    ok = ((yy >= margin) & (yy < h - margin) & (xx >= margin)
          & (xx < w - margin))
    return torch.where(ok, score, torch.zeros_like(score))


def grid_shape(h: int, w: int, cell: int) -> tuple[int, int]:
    return (h + cell - 1) // cell, (w + cell - 1) // cell


def _cell_reduce(score_map, n_rows, n_cols, gl):
    cells = score_map.reshape(n_rows, gl, n_cols, gl).permute(0, 2, 1, 3)
    cells = cells.reshape(n_rows, n_cols, gl * gl)
    cmax = cells.amax(dim=-1)
    carg = torch.argmax(cells, dim=-1)       # first maximum
    return cmax, carg // gl, carg % gl


def _lexsort(keys):
    """Indices sorting by the LAST key first, ties by the earlier keys, then
    by index (jnp.lexsort order) — successive stable sorts."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def detect_features(pyr, occupied_cells, cfg: SVOConfig, n_levels=None):
    """Best corner per grid cell across pyramid levels; with
    `cfg.edgelet_detection` a cell with no qualifying corner takes its
    strongest-gradient pixel as an EDGELET (score |grad|^2, unit gradient
    direction in `grad`) when |grad| > `cfg.edgelet_grad_min`.  Returns a
    dict of per-cell arrays: px (level-0), level, score, valid, ftype,
    grad."""
    n_levels = n_levels if n_levels is not None else cfg.n_pyr_levels
    h, w = pyr[0].shape
    g = cfg.grid_size
    assert g % (2 ** (n_levels - 1)) == 0, (
        "grid_size must be divisible by 2^(n_levels-1) for reshape NMS")
    n_rows, n_cols = grid_shape(h, w, g)
    n_cells = n_rows * n_cols
    dtype = pyr[0].dtype
    dev = pyr[0].device

    best_score, best_xy = [], []
    eg_score, eg_xy, eg_dir = [], [], []
    for level in range(n_levels):
        img = pyr[level]
        hl, wl = img.shape
        gl = g // (2 ** level)
        ph, pw = n_rows * gl, n_cols * gl
        scale = float(2 ** level)
        score = shi_tomasi_score_map(img)
        score = torch.where(fast_corner_mask(img, cfg.fast_threshold), score,
                            torch.zeros_like(score))
        score = _mask_margin(score, EDGE_MARGIN)
        score = F.pad(score, (0, pw - wl, 0, ph - hl))
        cmax, yl, xl = _cell_reduce(score, n_rows, n_cols, gl)
        cy = torch.arange(n_rows, device=dev)[:, None] * gl + yl
        cx = torch.arange(n_cols, device=dev)[None, :] * gl + xl
        best_score.append(cmax)
        best_xy.append(torch.stack([cx.to(dtype) * scale,
                                    cy.to(dtype) * scale], dim=-1))

        if cfg.edgelet_detection:
            # central differences span 2 px: x0.25 puts |grad|^2 in
            # per-pixel units
            dx, dy = _central_diff(img)
            gmag = _mask_margin(0.25 * (dx * dx + dy * dy), EDGE_MARGIN)
            gmag = F.pad(gmag, (0, pw - wl, 0, ph - hl))
            emax, eyl, exl = _cell_reduce(gmag, n_rows, n_cols, gl)
            ey = torch.arange(n_rows, device=dev)[:, None] * gl + eyl
            ex = torch.arange(n_cols, device=dev)[None, :] * gl + exl
            # the argmax may sit in the grid's padding: read the gradient
            # at the clipped pixel, as the JAX gather clamps
            eyc = torch.clamp(ey, 0, hl - 1)
            exc = torch.clamp(ex, 0, wl - 1)
            gdx = dx[eyc, exc]
            gdy = dy[eyc, exc]
            norm = torch.sqrt(torch.clamp(gdx * gdx + gdy * gdy, min=1e-12))
            eg_score.append(emax)
            eg_xy.append(torch.stack([ex.to(dtype) * scale,
                                      ey.to(dtype) * scale], dim=-1))
            eg_dir.append(torch.stack([gdx / norm, gdy / norm], dim=-1))
    best_score = torch.stack(best_score, 0)
    best_xy = torch.stack(best_xy, 0)

    lvl = torch.argmax(best_score, dim=0)                   # first maximum
    score = torch.amax(best_score, dim=0)
    xy = torch.gather(best_xy, 0, lvl[None, :, :, None].expand(
        1, n_rows, n_cols, 2))[0]

    score = score.reshape(n_cells)
    xy = xy.reshape(n_cells, 2)
    lvl = lvl.reshape(n_cells).to(torch.int32)
    valid = score > cfg.triang_min_corner_score
    ftype = torch.zeros((n_cells,), dtype=torch.int32, device=dev)
    grad = torch.zeros((n_cells, 2), dtype=dtype, device=dev)

    if cfg.edgelet_detection:
        eg_score = torch.stack(eg_score, 0)
        elvl = torch.argmax(eg_score, dim=0)               # first maximum
        escore = torch.amax(eg_score, dim=0).reshape(n_cells)
        pick = elvl[None, :, :, None].expand(1, n_rows, n_cols, 2)
        exy = torch.gather(torch.stack(eg_xy, 0), 0, pick)[0].reshape(
            n_cells, 2)
        edir = torch.gather(torch.stack(eg_dir, 0), 0, pick)[0].reshape(
            n_cells, 2)
        elvl = elvl.reshape(n_cells).to(torch.int32)
        # a corner wins its cell; an edgelet needs a strong gradient
        is_edge = ~valid & (escore > cfg.edgelet_grad_min ** 2)
        xy = torch.where(is_edge[:, None], exy, xy)
        lvl = torch.where(is_edge, elvl, lvl)
        score = torch.where(is_edge, escore, score)
        ftype = torch.where(is_edge, FTYPE_EDGELET, ftype)
        grad = torch.where(is_edge[:, None], edir, grad)
        valid = valid | is_edge

    if occupied_cells is not None:
        valid = valid & ~occupied_cells
    if n_cells > cfg.max_fts:
        # keep exactly max_fts cells: valid first, corners before edgelets,
        # higher score first, lower index on ties
        corner = (ftype == FTYPE_CORNER).to(torch.int32)
        order = _lexsort((-score, -corner, (~valid).to(torch.int32)))
        keep = torch.zeros((n_cells,), dtype=torch.bool, device=dev)
        keep = keep.index_put((order[:cfg.max_fts],),
                              torch.ones((), dtype=torch.bool, device=dev))
        valid = valid & keep
    return {"px": xy, "level": lvl, "score": score, "valid": valid,
            "ftype": ftype, "grad": grad}


def cell_index(px: torch.Tensor, w: int, cell: int, n_cols: int):
    """Grid-cell id of level-0 pixel coords."""
    cx = torch.div(px[..., 0], cell, rounding_mode="floor").to(torch.int32)
    cy = torch.div(px[..., 1], cell, rounding_mode="floor").to(torch.int32)
    return cy * n_cols + cx
