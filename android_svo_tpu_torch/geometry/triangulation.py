"""Two-view geometry — port of `android_svo_tpu/geometry/triangulation.py`.
All functions broadcast over leading batch dimensions."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.geometry.se3 import SE3


def triangulate_midpoint(T_w_ref: SE3, T_w_cur: SE3,
                         f_ref: torch.Tensor, f_cur: torch.Tensor):
    """Midpoint triangulation in world frame."""
    r_ref = T_w_ref.rotate(f_ref)
    r_cur = T_w_cur.rotate(f_cur)
    b = T_w_cur.t - T_w_ref.t
    a00 = torch.sum(r_ref * r_ref, dim=-1)
    a01 = -torch.sum(r_ref * r_cur, dim=-1)
    a11 = torch.sum(r_cur * r_cur, dim=-1)
    b0 = torch.sum(r_ref * b, dim=-1)
    b1 = -torch.sum(r_cur * b, dim=-1)
    det = a00 * a11 - a01 * a01
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    d_ref = (a11 * b0 - a01 * b1) / det
    d_cur = (a00 * b1 - a01 * b0) / det
    p_ref = T_w_ref.t + d_ref[..., None] * r_ref
    p_cur = T_w_cur.t + d_cur[..., None] * r_cur
    return 0.5 * (p_ref + p_cur)


def depth_from_triangulation(T_cur_ref: SE3, f_ref: torch.Tensor,
                             f_cur: torch.Tensor):
    """Depth along the reference bearing; returns (depth, valid) with the
    determinant gate on the normalized system."""
    rf = T_cur_ref.rotate(f_ref)
    a00 = torch.sum(rf * rf, dim=-1)
    a01 = -torch.sum(rf * f_cur, dim=-1)
    a11 = torch.sum(f_cur * f_cur, dim=-1)
    b0 = torch.sum(rf * T_cur_ref.t, dim=-1)
    b1 = -torch.sum(f_cur * T_cur_ref.t, dim=-1)
    det = a00 * a11 - a01 * a01
    valid = torch.abs(det) >= 1e-6
    det_safe = torch.where(valid, det, torch.ones_like(det))
    depth = (a11 * b0 - a01 * b1) / det_safe
    return torch.abs(depth), valid


def reproj_error_unit_plane(f: torch.Tensor, xyz_cam: torch.Tensor):
    uv_f = f[..., :2] / f[..., 2:3]
    uv_p = xyz_cam[..., :2] / xyz_cam[..., 2:3]
    return torch.linalg.norm(uv_f - uv_p, dim=-1)


def compute_inliers(T_cur_ref: SE3, f_ref: torch.Tensor, f_cur: torch.Tensor,
                    reproj_thresh, focal):
    """Triangulate every correspondence and classify inliers by two-view
    reprojection error.  Returns (xyz_in_cur, inlier_mask, error_sum)."""
    T_ref_cur = T_cur_ref.inverse()
    ident = SE3.identity(dtype=f_ref.dtype, device=f_ref.device)
    xyz_cur = triangulate_midpoint(T_cur_ref, ident, f_ref, f_cur)
    xyz_ref = T_ref_cur.apply(xyz_cur)
    e_cur = reproj_error_unit_plane(f_cur, xyz_cur) * focal
    e_ref = reproj_error_unit_plane(f_ref, xyz_ref) * focal
    err = e_cur + e_ref
    inlier = ((err < 2.0 * reproj_thresh)
              & (xyz_cur[..., 2] > 0) & (xyz_ref[..., 2] > 0))
    return xyz_cur, inlier, torch.sum(torch.where(inlier, err,
                                                  torch.zeros_like(err)), -1)


def sampson_error(E: torch.Tensor, f_ref: torch.Tensor,
                  f_cur: torch.Tensor) -> torch.Tensor:
    """First-order geometric error of f_cur^T E f_ref."""
    Ef1 = torch.einsum("...ij,...nj->...ni", E, f_ref)
    Etf2 = torch.einsum("...ji,...nj->...ni", E, f_cur)
    num = torch.einsum("...ni,...ni->...n", f_cur, Ef1)
    den = (Ef1[..., 0] ** 2 + Ef1[..., 1] ** 2
           + Etf2[..., 0] ** 2 + Etf2[..., 1] ** 2)
    return num * num / torch.clamp(den, min=1e-12)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of the valid entries (index (n-1)//2 of the sorted
    valid values), arena-safe: padding sorts to +inf."""
    n = torch.sum(mask.to(torch.int64))
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))),
                    dim=-1).values
    return xs[torch.clamp(n - 1, min=0) // 2]
