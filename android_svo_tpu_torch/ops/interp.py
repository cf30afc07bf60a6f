"""Bilinear sampling and patch extraction — port of
`android_svo_tpu/ops/interp.py`.

Coordinates are (x, y) pixels; integer coordinates hit pixel centres.
Out-of-bounds reads clamp to the border exactly as the JAX version's index
clamps do (floor, clip x0 to [0, w-1], x1 = clip(x0+1)); validity is the
caller's mask.
"""

from __future__ import annotations

import torch


def _floor_index(xf: torch.Tensor, n: int):
    """clip(int(floor(x)), 0, n-1) and clip(that+1, 0, n-1), with the float
    clamped before the cast so NaN/huge coordinates stay defined."""
    i0 = torch.nan_to_num(xf, nan=0.0).clamp(-1.0, float(n)).to(torch.int64)
    i0 = i0.clamp(0, n - 1)
    return i0, (i0 + 1).clamp(0, n - 1)


def _lerp2(v00, v01, v10, v11, wx, wy):
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at uv (..., 2) float pixel coords, bilinear."""
    h, w = img.shape
    x = uv[..., 0]
    y = uv[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0, x1 = _floor_index(x0f, w)
    y0, y1 = _floor_index(y0f, h)
    return _lerp2(img[y0, x0], img[y0, x1], img[y1, x0], img[y1, x1], wx, wy)


def patch_offsets(halfsize: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """(P*P, 2) offsets covering a (2*halfsize)^2 patch, x fastest, top-left
    at -halfsize."""
    p = 2 * halfsize
    r = torch.arange(p, dtype=dtype, device=device) - halfsize
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def extract_patches(img: torch.Tensor, centers: torch.Tensor,
                    halfsize: int) -> torch.Tensor:
    """Bilinear patches (N, P, P) at float centres (N, 2)."""
    p = 2 * halfsize
    offs = patch_offsets(halfsize, centers.dtype, centers.device)
    coords = centers[:, None, :] + offs[None, :, :]
    return bilinear_sample(img, coords).reshape(centers.shape[0], p, p)


def extract_patches_with_grad(img: torch.Tensor, centers: torch.Tensor,
                              halfsize: int):
    """Patches plus central-difference image gradients at the same sample
    positions, 0.5 * (I(x+1) - I(x-1)) as the reference takes them
    (sparse_img_align.cpp:150-170): returns (patch, dx, dy), each
    (N, P, P)."""
    p = 2 * halfsize
    n = centers.shape[0]
    offs = patch_offsets(halfsize, centers.dtype, centers.device)
    coords = centers[:, None, :] + offs[None, :, :]
    ex = torch.tensor([1.0, 0.0], dtype=centers.dtype, device=centers.device)
    ey = torch.tensor([0.0, 1.0], dtype=centers.dtype, device=centers.device)
    val = bilinear_sample(img, coords)
    dx = 0.5 * (bilinear_sample(img, coords + ex)
                - bilinear_sample(img, coords - ex))
    dy = 0.5 * (bilinear_sample(img, coords + ey)
                - bilinear_sample(img, coords - ey))
    return (val.reshape(n, p, p), dx.reshape(n, p, p), dy.reshape(n, p, p))


def bilinear_sample_stack(imgs: torch.Tensor, idx: torch.Tensor,
                          uv: torch.Tensor) -> torch.Tensor:
    """Sample a stack (K, H, W) at per-item image index idx (N,) and coords
    uv (N, ..., 2).  The image index is normalised and clamped as JAX's
    gather does (negative indices count from the end, then clip)."""
    k, h, w = imgs.shape
    x = uv[..., 0]
    y = uv[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0, x1 = _floor_index(x0f, w)
    y0, y1 = _floor_index(y0f, h)
    ii = idx.to(torch.int64)
    ii = torch.where(ii < 0, ii + k, ii).clamp(0, k - 1)
    ii = ii.reshape(ii.shape + (1,) * (uv.dim() - 2))
    return _lerp2(imgs[ii, y0, x0], imgs[ii, y0, x1], imgs[ii, y1, x0],
                  imgs[ii, y1, x1], wx, wy)


def in_bounds(uv: torch.Tensor, h, w, margin) -> torch.Tensor:
    """Validity of sample centres with a border margin; h/w may be ints or
    per-item tensors."""
    return ((uv[..., 0] >= margin) & (uv[..., 0] < w - 1 - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < h - 1 - margin))
