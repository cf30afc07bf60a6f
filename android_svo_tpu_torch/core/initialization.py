"""Two-frame monocular bootstrap — port of
`android_svo_tpu/core/initialization.py`: pyramidal KLT, fixed-trial
vectorized essential (8-point) and homography (4-point DLT) RANSAC,
cheirality, triangulation and map scaling.

The RANSAC draws come in as arguments: two `(ransac_n_trials, C)` tensors of
uniforms in [0, 1), made by the caller from a `torch.Generator` (tests pass
in the JAX package's draws so both sides sample the same minimal sets).
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.geometry.camera import project2d
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.geometry.triangulation import (
    compute_inliers, masked_median, sampson_error, triangulate_midpoint)
from android_svo_tpu_torch.ops import interp
from android_svo_tpu_torch.ops.feature_align import align2d, patch_gradients


def track_klt(ref_pyr, cur_pyr, px_ref, valid, cfg: SVOConfig,
              halfpatch: int = 7):
    """Track px_ref from ref to cur coarse-to-fine.  Returns (px_cur,
    tracked_mask)."""
    px_cur = px_ref
    tracked = valid
    for level in range(cfg.klt_max_level, -1, -1):
        s = 2.0 ** level
        pb = interp.extract_patches(ref_pyr[level], px_ref / s, halfpatch + 1)
        patch, gx, gy = patch_gradients(pb)
        uv, conv, _ = align2d(cur_pyr[level], patch, gx, gy, px_cur / s,
                              tracked, n_iter=cfg.klt_n_iter)
        px_cur = torch.where(tracked[:, None], uv * s, px_cur)
        if level == 0:
            tracked = tracked & conv
    h, w = cur_pyr[0].shape
    tracked = tracked & interp.in_bounds(px_cur, h, w, halfpatch + 2)
    return px_cur, tracked


def _unproj(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def _eight_point(uv1, uv2):
    """(T, 8, 2) x2 unit-plane coords -> (T, 3, 3) rank-2 essentials."""
    u1, v1 = uv1[..., 0], uv1[..., 1]
    u2, v2 = uv2[..., 0], uv2[..., 1]
    one = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one],
                    dim=-1)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    E = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    u, s, vt2 = torch.linalg.svd(E)
    d = torch.zeros_like(s)
    d[..., 0] = 1.0
    d[..., 1] = 1.0
    return u @ (d[..., None] * vt2)


def _decompose_essential(E):
    """E -> four (R, t) candidates."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[..., :, 2]
    return ((R1, t), (R1, -t), (R2, t), (R2, -t))


def _pick_by_cheirality(cands, f_ref, f_cur, inlier, skip_degenerate=False):
    dtype = f_ref.dtype
    dev = f_ref.device
    ident = SE3.identity(dtype=dtype, device=dev)
    best_cnt = torch.tensor(-1, dtype=torch.int32, device=dev)
    bq = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev)
    bt = torch.zeros((3,), dtype=dtype, device=dev)
    for R, t in cands:
        if skip_degenerate:
            tn = torch.linalg.norm(t)
            t = t / torch.clamp(tn, min=1e-12)
        Tc = SE3.from_rt(R, t)
        xyz_cur = triangulate_midpoint(Tc, ident, f_ref, f_cur)
        xyz_ref = Tc.inverse().apply(xyz_cur)
        cnt = torch.sum(inlier & (xyz_cur[..., 2] > 0)
                        & (xyz_ref[..., 2] > 0)).to(torch.int32)
        if skip_degenerate:
            cnt = torch.where(tn < 1e-6, torch.full_like(cnt, -1), cnt)
        better = cnt > best_cnt
        bq = torch.where(better, Tc.q, bq)
        bt = torch.where(better, Tc.t, bt)
        best_cnt = torch.where(better, cnt, best_cnt)
    return SE3(q=bq, t=bt)


def _minimal_sets(draws, valid, k: int):
    r = torch.where(valid[None, :], draws,
                    torch.full_like(draws, float("inf")))
    return torch.argsort(r, dim=-1, stable=True)[:, :k]


def estimate_relpose_ransac(f_ref, f_cur, valid, focal, cfg: SVOConfig,
                            draws):
    """Fixed-trial RANSAC on the epipolar constraint.  Returns (T_cur_ref
    with unit translation, inlier_mask)."""
    uv_ref = project2d(f_ref)
    uv_cur = project2d(f_cur)
    idx = _minimal_sets(draws, valid, 8)
    E = _eight_point(uv_ref[idx], uv_cur[idx])
    err = sampson_error(E, _unproj(uv_ref), _unproj(uv_cur))
    thresh = (cfg.ransac_thresh_px / focal) ** 2
    inl = (err < thresh) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))
    inlier = inl[best]
    T = _pick_by_cheirality(_decompose_essential(E[best]), f_ref, f_cur,
                            inlier)
    return T, inlier


def _four_point_dlt(uv1, uv2):
    u1, v1 = uv1[..., 0], uv1[..., 1]
    u2, v2 = uv2[..., 0], uv2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    rx = torch.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], dim=-1)
    ry = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    A = torch.cat([rx, ry], dim=-2)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))


def _homography_transfer_err(H, uv1, uv2):
    p = torch.einsum("tij,cj->tci", H, _unproj(uv1))
    z = torch.where(torch.abs(p[..., 2]) < 1e-12,
                    torch.full_like(p[..., 2], 1e-12), p[..., 2])
    d = p[..., :2] / z[..., None] - uv2[None]
    return torch.sum(d * d, dim=-1)


def _decompose_homography(H):
    """Faugeras SVD decomposition into 8 (R, t, n) candidates."""
    U, S, Vt = torch.linalg.svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    V = Vt.T
    d2s = torch.clamp(d2, min=1e-12)
    zero = torch.zeros_like(d1)
    out = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sin_t = (d1 - d3) * e1 * x1 * e3 * x3 / d2s
            cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
            Rp = torch.stack([torch.stack([cos_t, zero, -sin_t]),
                              torch.stack([zero, zero + 1.0, zero]),
                              torch.stack([sin_t, zero, cos_t])])
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
            npv = torch.stack([e1 * x1, zero, e3 * x3])
            out.append((s * U @ Rp @ Vt, U @ tp, V @ npv))
            sin_p = (d1 + d3) * e1 * x1 * e3 * x3 / d2s
            cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
            Rp2 = torch.stack([torch.stack([cos_p, zero, sin_p]),
                               torch.stack([zero, zero - 1.0, zero]),
                               torch.stack([sin_p, zero, -cos_p])])
            tp2 = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3])
            out.append((s * U @ Rp2 @ Vt, U @ tp2, V @ npv))
    return out


def estimate_homography_ransac(f_ref, f_cur, valid, focal, cfg: SVOConfig,
                               draws):
    """Fixed-trial homography RANSAC + decomposition.  Returns (T_cur_ref
    with unit translation, inlier_mask)."""
    uv_ref = project2d(f_ref)
    uv_cur = project2d(f_cur)
    idx = _minimal_sets(draws, valid, 4)
    Hs = _four_point_dlt(uv_ref[idx], uv_cur[idx])
    err = _homography_transfer_err(Hs, uv_ref, uv_cur)
    thresh = (cfg.ransac_thresh_px / focal) ** 2
    inl = (err < thresh) & valid[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))
    inlier = inl[best]
    cands = [(R, t) for R, t, _ in _decompose_homography(Hs[best])]
    T = _pick_by_cheirality(cands, f_ref, f_cur, inlier,
                            skip_degenerate=True)
    return T, inlier


def ransac_draws(cfg: SVOConfig, n: int, generator: torch.Generator,
                 device=None):
    """The two (ransac_n_trials, n) uniform draws of one bootstrap attempt
    (essential, homography), made on the generator's device and moved."""
    shape = (cfg.ransac_n_trials, n)
    de = torch.rand(shape, generator=generator, dtype=torch.float32)
    dh = torch.rand(shape, generator=generator, dtype=torch.float32)
    return de.to(device), dh.to(device)


def bootstrap_pair(ref_pyr, cur_pyr, cam, px_ref, valid, cfg: SVOConfig,
                   draws_e, draws_h):
    """Relative pose (scaled so the median depth is `map_scale`), points
    triangulated in the ref frame, masks and diagnostics."""
    dtype = px_ref.dtype
    dev = px_ref.device
    px_cur, tracked = track_klt(ref_pyr, cur_pyr, px_ref, valid, cfg)
    disparity = masked_median(torch.linalg.norm(px_cur - px_ref, dim=-1),
                              tracked)
    f_ref = cam.cam2world(px_ref)
    f_cur = cam.cam2world(px_cur)
    focal = cam.errorMultiplier2()
    T_e, _ = estimate_relpose_ransac(f_ref, f_cur, tracked, focal, cfg,
                                     draws_e)
    T_h, _ = estimate_homography_ransac(f_ref, f_cur, tracked, focal, cfg,
                                        draws_h)
    thr = torch.tensor(cfg.reproj_thresh, dtype=dtype, device=dev)
    _, inl_e, _ = compute_inliers(T_e, f_ref, f_cur, thr, focal)
    _, inl_h, _ = compute_inliers(T_h, f_ref, f_cur, thr, focal)
    inl_e = inl_e & tracked
    inl_h = inl_h & tracked
    use_h = torch.sum(inl_h) > torch.sum(inl_e)
    T_cur_ref = SE3(q=torch.where(use_h, T_h.q, T_e.q),
                    t=torch.where(use_h, T_h.t, T_e.t))
    inlier = torch.where(use_h, inl_h, inl_e)

    ident = SE3.identity(dtype=dtype, device=dev)
    xyz_ref = triangulate_midpoint(ident, T_cur_ref.inverse(), f_ref, f_cur)
    good = inlier & (xyz_ref[..., 2] > 1e-3)
    z_cur = T_cur_ref.apply(xyz_ref)[..., 2]
    good = good & (z_cur > 1e-3)

    depth_med = masked_median(xyz_ref[..., 2], good)
    scale = cfg.map_scale / torch.clamp(depth_med, min=1e-6)
    xyz_ref = xyz_ref * scale
    T_scaled = SE3(q=T_cur_ref.q, t=T_cur_ref.t * scale)
    return {
        "T_cur_ref": T_scaled, "px_cur": px_cur, "f_ref": f_ref,
        "f_cur": f_cur, "xyz_ref": xyz_ref, "tracked": tracked,
        "inlier": good, "disparity": disparity,
        "n_tracked": torch.sum(tracked).to(torch.int32),
        "n_inliers": torch.sum(good).to(torch.int32),
    }
