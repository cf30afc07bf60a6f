"""Inverse-compositional Lucas-Kanade alignment on one image level — port of
`android_svo_tpu/ops/feature_align.py`: `patch_gradients`, `align2d` (the
bootstrap's KLT runs on it) and `align1d`.  Plain PyTorch, as the JAX
module is plain `jnp`; the pyramid-stack forms the tracker runs are
`ops/patch_kernels.py::align_iclk` and `ops/matcher.py::align1d_stack`."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.geometry.linsolve import inv_spd
from android_svo_tpu_torch.ops import interp

MIN_UPDATE_SQUARED = 0.03 * 0.03


def patch_gradients(patch_with_border: torch.Tensor):
    """Central-difference gradients of the interior of (N, P+2, P+2)
    patches -> (patch (N,P,P), dx, dy)."""
    pb = patch_with_border
    inner = pb[:, 1:-1, 1:-1]
    dx = 0.5 * (pb[:, 1:-1, 2:] - pb[:, 1:-1, :-2])
    dy = 0.5 * (pb[:, 2:, 1:-1] - pb[:, :-2, 1:-1])
    return inner, dx, dy


def align2d(img, ref_patch, ref_dx, ref_dy, init_uv, valid, n_iter: int = 10):
    """Batched 2D ICLK with mean-brightness term on one (H, W) image.
    Returns (uv, converged, mean_diff)."""
    n, p, _ = ref_patch.shape
    half = p // 2
    h, w = img.shape
    area = p * p
    dtype = ref_patch.dtype
    T = ref_patch.reshape(n, area)
    gx = ref_dx.reshape(n, area)
    gy = ref_dy.reshape(n, area)
    J = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    H = torch.einsum("nai,naj->nij", J, J)
    H = H + 1e-6 * torch.eye(3, dtype=dtype, device=img.device)
    Hinv = inv_spd(H)

    def update(uv, mean_diff):
        cur = interp.extract_patches(img, uv, half).reshape(n, area)
        r = cur - T + mean_diff[:, None]
        g = torch.einsum("nai,na->ni", J, r)
        return torch.einsum("nij,nj->ni", Hinv, g)

    uv = init_uv
    mean_diff = torch.zeros((n,), dtype=dtype, device=img.device)
    for _ in range(n_iter):
        ok = valid & interp.in_bounds(uv, h, w, half + 1)
        upd = update(uv, mean_diff)
        uv = torch.where(ok[:, None], uv - upd[:, :2], uv)
        mean_diff = torch.where(ok, mean_diff - upd[:, 2], mean_diff)

    ok = valid & interp.in_bounds(uv, h, w, half + 1)
    upd = update(uv, mean_diff)
    step2 = torch.sum(upd[:, :2] ** 2, dim=-1)
    drift = torch.linalg.norm(uv - init_uv, dim=-1)
    converged = ok & (step2 < 4.0 * MIN_UPDATE_SQUARED) & (drift < p)
    return uv, converged, mean_diff


def align1d(img, ref_patch, ref_dx, ref_dy, direction, init_uv, valid,
            n_iter: int = 10):
    """Batched 1D ICLK along a unit `direction` (N, 2) (epipolar line or
    edgelet normal) with mean-brightness term on one (H, W) image (ref
    feature_alignment.cpp:35-133).  Parameters per feature: (step along
    the direction, d_mean).  Returns (uv, converged, mean_diff)."""
    n, p, _ = ref_patch.shape
    half = p // 2
    h, w = img.shape
    area = p * p
    dtype = ref_patch.dtype
    T = ref_patch.reshape(n, area)
    gdir = (direction[:, 0:1] * ref_dx.reshape(n, area)
            + direction[:, 1:2] * ref_dy.reshape(n, area))
    J = torch.stack([gdir, torch.ones_like(gdir)], dim=-1)
    H = torch.einsum("nai,naj->nij", J, J)
    H = H + 1e-6 * torch.eye(2, dtype=dtype, device=img.device)
    Hinv = inv_spd(H)

    uv = init_uv
    mean_diff = torch.zeros((n,), dtype=dtype, device=img.device)
    for _ in range(n_iter):
        ok = valid & interp.in_bounds(uv, h, w, half + 1)
        cur = interp.extract_patches(img, uv, half).reshape(n, area)
        r = cur - T + mean_diff[:, None]
        g = torch.einsum("nai,na->ni", J, r)
        upd = torch.einsum("nij,nj->ni", Hinv, g)
        uv = torch.where(ok[:, None], uv - upd[:, 0:1] * direction, uv)
        mean_diff = torch.where(ok, mean_diff - upd[:, 1], mean_diff)
    ok = valid & interp.in_bounds(uv, h, w, half + 1)
    drift = torch.linalg.norm(uv - init_uv, dim=-1)
    return uv, ok & (drift < p), mean_diff
