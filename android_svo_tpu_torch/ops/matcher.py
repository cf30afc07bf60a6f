"""Patch warping and direct matching — port of the parts of
`android_svo_tpu/ops/matcher.py` on the tracking path: the affine warp out
of the keyframe arena, search-level selection, ZMSSD, the cached direct
match (`match_cached`) and the epipolar search (`find_epipolar_match`).

`find_match_direct`, the 1D alignment (`epi_search_1d`) and the edgelet
branches are not ported yet and raise.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.config import SVOConfig, not_ported
from android_svo_tpu_torch.geometry.camera import project2d
from android_svo_tpu_torch.geometry.linsolve import det2x2, inv2x2
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.geometry.triangulation import (
    depth_from_triangulation)
from android_svo_tpu_torch.ops import interp
from android_svo_tpu_torch.ops import patch_kernels as pk
from android_svo_tpu_torch.ops.feature_align import patch_gradients


def get_warp_matrix_affine(cam, px_ref, f_ref, depth_ref, T_cur_ref: SE3,
                           level_ref, halfpatch: int) -> torch.Tensor:
    """First-order affine approximation A_cur_ref (N, 2, 2) of the ref->cur
    pixel warp around each feature."""
    xyz_ref = f_ref * depth_ref[..., None]
    step = (halfpatch + 1) * (2.0 ** level_ref.to(px_ref.dtype))
    zero = torch.zeros_like(step)
    px_du = px_ref + torch.stack([step, zero], dim=-1)
    px_dv = px_ref + torch.stack([zero, step], dim=-1)
    f_du = cam.cam2world(px_du)
    f_dv = cam.cam2world(px_dv)
    z = xyz_ref[..., 2:3]
    xyz_du = f_du / f_du[..., 2:3] * z
    xyz_dv = f_dv / f_dv[..., 2:3] * z
    uv_cur = cam.world2cam(T_cur_ref.apply(xyz_ref))
    uv_du = cam.world2cam(T_cur_ref.apply(xyz_du))
    uv_dv = cam.world2cam(T_cur_ref.apply(xyz_dv))
    col0 = (uv_du - uv_cur) / step[..., None]
    col1 = (uv_dv - uv_cur) / step[..., None]
    return torch.stack([col0, col1], dim=-1)


def get_best_search_level(A_cur_ref: torch.Tensor, max_level: int):
    """Pyramid level where the warped patch area shrinks below 3."""
    D = torch.abs(det2x2(A_cur_ref))
    level = torch.zeros(D.shape, dtype=torch.int32, device=D.device)
    for _ in range(max_level):
        step_up = D > 3.0
        level = level + step_up.to(torch.int32)
        D = torch.where(step_up, D * 0.25, D)
    return torch.clamp(level, max=max_level)


def warp_affine_stack(kf_stack, kf_idx, A_cur_ref, px_ref, level_ref,
                      search_level, halfpatch_border: int, h: int, w: int):
    """Warp reference patches (with border) out of the keyframe arena
    (K, L, Hp, Wp).  Returns (N, P, P) patches, P = 2*halfpatch_border, and
    a validity mask (A invertible)."""
    n = px_ref.shape[0]
    p = 2 * halfpatch_border
    dtype = px_ref.dtype
    dev = px_ref.device
    K, L, Hp, Wp = kf_stack.shape
    det = det2x2(A_cur_ref)
    ok = torch.abs(det) > 1e-8
    eye = torch.eye(2, dtype=dtype, device=dev)
    A_safe = torch.where(ok[:, None, None], A_cur_ref, eye)
    A_ref_cur = inv2x2(A_safe)

    lvl = torch.clamp(level_ref.to(torch.int64), 0, L - 1)
    offs = interp.patch_offsets(halfpatch_border, dtype, dev)
    scale_s = (2.0 ** search_level.to(dtype))[:, None, None]
    d_ref0 = torch.einsum("nij,aj->nai", A_ref_cur, offs) * scale_s
    scale_r = (2.0 ** lvl.to(dtype))[:, None, None]
    coords = (px_ref[:, None, :] + d_ref0) / scale_r
    wl = (w >> lvl).to(dtype)[:, None]
    hl = (h >> lvl).to(dtype)[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    coords = torch.stack([
        torch.minimum(torch.maximum(coords[..., 0], zero), wl - 1.001),
        torch.minimum(torch.maximum(coords[..., 1], zero), hl - 1.001)],
        dim=-1)
    merged = kf_stack.reshape(K * L, Hp, Wp)
    idx = torch.clamp(kf_idx.to(torch.int64), 0, K - 1) * L + lvl
    vals = interp.bilinear_sample_stack(merged, idx, coords)
    return vals.reshape(n, p, p), ok


def zmssd(ref_patch: torch.Tensor, cur_patches: torch.Tensor):
    """Zero-mean SSD between ref (..., A) and candidates (..., K, A)."""
    r = ref_patch - ref_patch.mean(dim=-1, keepdim=True)
    c = cur_patches - cur_patches.mean(dim=-1, keepdim=True)
    d = c - r[..., None, :]
    return torch.sum(d * d, dim=-1)


def _zmssd_accept(cur_stack, search_level, ref_patch, uv_out, ok,
                  cfg: SVOConfig, use_pallas):
    """Appearance gate on a converged direct match (ZMSSD threshold and the
    population-std information floor)."""
    n, p, _ = ref_patch.shape
    area = p * p
    cur = pk.sample_patches(cur_stack, search_level, uv_out, p // 2,
                            valid=ok, use_pallas=use_pallas)
    cur = cur.reshape(n, area)
    score = zmssd(ref_patch.reshape(n, area), cur[:, None, :])[:, 0]
    textured = cur.std(dim=-1, correction=0) >= cfg.match_min_patch_std
    return ok & textured & (score < cfg.zmssd_threshold_factor * area)


def compute_warp_batch(kf_stack, kf_idx, cam, px_ref, f_ref, depth_ref,
                       level_ref, T_cur_ref: SE3, valid, cfg: SVOConfig,
                       ref_grad=None):
    """Affine matrix -> search level -> border patch.  Returns (patch_b,
    search_level, grad_cur, ok); grad_cur is the warped gradient direction
    for edgelets (None when `ref_grad` is None)."""
    halfpatch = cfg.patch_halfsize
    h, w = cam.height, cam.width
    A = get_warp_matrix_affine(cam, px_ref, f_ref, depth_ref, T_cur_ref,
                               level_ref, halfpatch)
    search_level = get_best_search_level(A, cfg.max_search_level)
    patch_b, ok_warp = warp_affine_stack(
        kf_stack, kf_idx, A, px_ref, level_ref, search_level,
        halfpatch + 1, h, w)
    if ref_grad is not None:
        g = torch.einsum("nij,nj->ni", A, ref_grad)
        grad_cur = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                                   min=1e-8)
    else:
        grad_cur = None
    return patch_b, search_level, grad_cur, valid & ok_warp


def identity_warp_patches(kf_stack, kf_idx, px_ref, level_ref, valid,
                          cfg: SVOConfig, h: int, w: int):
    """Spawn-time cache fill with the zero-baseline (identity) warp.
    Returns (patch_b, search_level, ok)."""
    n = px_ref.shape[0]
    A = torch.eye(2, dtype=px_ref.dtype, device=px_ref.device).expand(n, 2, 2)
    search_level = torch.zeros((n,), dtype=torch.int32, device=px_ref.device)
    patch_b, ok_warp = warp_affine_stack(
        kf_stack, kf_idx, A, px_ref, level_ref, search_level,
        cfg.patch_halfsize + 1, h, w)
    return patch_b, search_level, valid & ok_warp


def match_cached(cur_stack, cam, ref_patch_b, search_level, px_cur_init,
                 valid, cfg: SVOConfig, warp_grad=None, ref_type=None):
    """Subpixel match against cached warped reference patches.  Returns
    (px_cur level-0, success)."""
    if cfg.edgelet_detection:
        raise not_ported("edgelet_detection", cfg.edgelet_detection)
    use_pallas = cfg.use_pallas
    h, w = cam.height, cam.width
    n_levels = min(cur_stack.shape[0], cfg.max_search_level + 1)
    cur_stack = cur_stack[:n_levels]
    search_level = torch.clamp(search_level, 0, n_levels - 1)
    ref_patch, gx, gy = patch_gradients(ref_patch_b)
    scale_s = 2.0 ** search_level.to(px_cur_init.dtype)
    uv_init = px_cur_init / scale_s[:, None]

    if cfg.align_mxu:
        gate = cfg.direct_match_zmssd
        uv_out, conv, _ = pk.align_iclk_mxu(
            cur_stack, search_level, ref_patch, gx, gy, uv_init, valid,
            cfg.align_max_iter, h, w, use_pallas=use_pallas,
            zmssd_factor=cfg.zmssd_threshold_factor if gate else None,
            min_patch_std=cfg.match_min_patch_std if gate else None)
        success = conv & valid
    else:
        uv_out, conv, _ = pk.align_iclk(
            cur_stack, search_level, ref_patch, gx, gy, uv_init, valid,
            cfg.align_max_iter, h, w, use_pallas=use_pallas)
        success = conv & valid
        if cfg.direct_match_zmssd:
            success = _zmssd_accept(cur_stack, search_level, ref_patch,
                                    uv_out, success, cfg, use_pallas)
    return uv_out * scale_s[:, None], success


def find_match_direct(*args, **kwargs):
    """Not ported: the tracking path serves direct matches from the warped
    patch cache (`match_cached`)."""
    raise not_ported("find_match_direct", "called")


def find_epipolar_match(cur_stack, kf_stack, kf_idx, cam, px_ref, f_ref,
                        level_ref, T_cur_ref: SE3, d_estimate, d_min, d_max,
                        valid, cfg: SVOConfig, cached=None):
    """ZMSSD scan along each seed's epipolar segment [d_min, d_max], subpixel
    refinement, and triangulated depth.  Returns (depth, px_cur, success)."""
    if cfg.epi_search_1d:
        raise not_ported("epi_search_1d", cfg.epi_search_1d)
    halfpatch = cfg.patch_halfsize
    area = (2 * halfpatch) ** 2
    dtype = px_ref.dtype
    use_pallas = cfg.use_pallas
    h, w = cam.height, cam.width
    n_levels = min(cur_stack.shape[0], cfg.max_search_level + 1)
    cur_stack = cur_stack[:n_levels]

    p_min = T_cur_ref.apply(f_ref * d_min[..., None])
    p_max = T_cur_ref.apply(f_ref * d_max[..., None])
    uv_A = project2d(p_min)
    uv_B = project2d(p_max)
    z_A = p_min[..., 2]
    z_B = p_max[..., 2]

    if cached is None:
        A_warp = get_warp_matrix_affine(cam, px_ref, f_ref, d_estimate,
                                        T_cur_ref, level_ref, halfpatch)
        search_level = get_best_search_level(A_warp, n_levels - 1)
        patch_b, ok_warp = warp_affine_stack(
            kf_stack, kf_idx, A_warp, px_ref, level_ref, search_level,
            halfpatch + 1, h, w)
    else:
        patch_b, search_level = cached
        search_level = torch.clamp(search_level, 0, n_levels - 1)
        ok_warp = torch.ones(search_level.shape, dtype=torch.bool,
                             device=search_level.device)
    ref_patch, gx, gy = patch_gradients(patch_b)

    px_A = cam.world2cam_uv(uv_A)
    px_B = cam.world2cam_uv(uv_B)
    scale_s = 2.0 ** search_level.to(dtype)
    epi_len = torch.linalg.norm(px_A - px_B, dim=-1) / scale_s

    Kmax = cfg.max_epi_search_steps
    n_steps = torch.nan_to_num(epi_len / 0.7, nan=0.0).clamp(
        max=2.0 ** 30).to(torch.int32) + 1
    too_long = n_steps > Kmax
    short = epi_len < 2.0
    scans = valid & ok_warp & ~short & ~too_long
    n_steps = torch.where(scans, torch.clamp(n_steps, 2, Kmax),
                          torch.zeros_like(n_steps))

    uv_a_l = px_A / scale_s[:, None]
    uv_b_l = px_B / scale_s[:, None]
    t_best, score_best = pk.epi_scan(
        cur_stack, search_level, uv_a_l, uv_b_l, ref_patch,
        n_steps_max=Kmax, half=halfpatch, n_steps_each=n_steps,
        h=h, w=w, use_pallas=use_pallas)
    px_best0 = px_A + (px_B - px_A) * t_best[:, None]

    thresh = cfg.zmssd_threshold_factor * area
    px_start0 = torch.where(short[:, None], 0.5 * (px_A + px_B), px_best0)
    score_ok = short | (score_best < thresh)

    valid_all = valid & ok_warp & score_ok & ~too_long
    uv_start = px_start0 / scale_s[:, None]
    uv_out, conv_out, _ = pk.align_iclk(
        cur_stack, search_level, ref_patch, gx, gy, uv_start, valid_all,
        cfg.subpix_n_iter, h, w, use_pallas=use_pallas)
    px_cur = uv_out * scale_s[:, None]

    f_cur = cam.cam2world(px_cur)
    depth, tri_ok = depth_from_triangulation(T_cur_ref, f_ref, f_cur)
    behind = (z_A <= 1e-3) & (z_B <= 1e-3)
    success = valid_all & conv_out & tri_ok & ~behind
    return depth, px_cur, success
