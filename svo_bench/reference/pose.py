"""Motion-only bundle adjustment as the tracking step runs it, plain torch —
frozen from the port's `core/pose_opt.py::optimize_pose` (Gauss-Newton),
with `geometry/robust.py` (`mad_scale`, `tukey_weight`),
`geometry/triangulation.py::masked_median` and the twist conventions of
`geometry/se3.py` and `ops/sparse_align.py::_geo_jacobian`, at 804481e.

Given a frame's starting pose, its matched world points and their measured
bearings, it refines the pose: residuals on the unit plane scaled by the
feature's level, Tukey weights over a MAD scale (re-seated at 0.85 px from
iteration 5 on), a damped Gauss-Newton step on the left and the step kept
only where it lowers the weighted cost.  Every matrix product (the
rotation of the points, the Jacobian, the normal equations) is a matmul,
so the lower-precision control is this function with each product's
operands rounded to TF32, float32 elsewhere.
"""

from __future__ import annotations

import torch

TUKEY_B = 8.6851
MAD_NORMALIZER = 1.48


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10-bit mantissa, to nearest, as the
    card rounds a matmul's operands with TF32 on."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    return torch.matmul(tf32(a), tf32(b)) if low else torch.matmul(a, b)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], dim=-2)


def quat_mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    pw, px, py, pz = p.unbind(-1)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack([pw * qw - px * qx - py * qy - pz * qz,
                        pw * qx + px * qw + py * qz - pz * qy,
                        pw * qy - px * qz + py * qw + pz * qx,
                        pw * qz + px * qy - py * qx + pz * qw], dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       -1).reshape(v.shape[:-1] + (3, 3))


def se3_exp(xi: torch.Tensor) -> tuple:
    """Twist (v, w) -> (q, t)."""
    rho, phi = xi[:3], xi[3:]
    theta = torch.linalg.norm(phi)
    th = float(theta)
    if th < 1e-8:
        q = torch.cat([torch.ones_like(phi[:1]), 0.5 * phi])
        V = torch.eye(3, dtype=xi.dtype, device=xi.device) + 0.5 * hat(phi)
    else:
        q = torch.cat([torch.cos(0.5 * theta)[None],
                       torch.sin(0.5 * theta) / theta * phi])
        K = hat(phi)
        V = (torch.eye(3, dtype=xi.dtype, device=xi.device)
             + (1 - torch.cos(theta)) / theta ** 2 * K
             + (theta - torch.sin(theta)) / theta ** 3 * (K @ K))
    return q / torch.linalg.norm(q), V @ rho


def lower_median(x: torch.Tensor) -> torch.Tensor:
    xs = torch.sort(x).values
    return xs[max(x.numel() - 1, 0) // 2]


def tukey(x: torch.Tensor) -> torch.Tensor:
    r = x / TUKEY_B
    return torch.where(r.abs() < 1.0, (1 - r * r) ** 2, torch.zeros_like(r))


def optimize_pose(q0, t0, p_w, f_meas, level, valid, focal: float,
                  n_iter: int, dtype=torch.float64, low: bool = False):
    """The refined pose (q, t) (world to frame) from the start (q0, t0),
    the world points p_w (N, 3), the bearings f_meas (N, 3), the pyramid
    levels and the valid rows; `low` rounds every product to TF32."""
    q, t = q0.to(dtype), t0.to(dtype)
    p_w, f_meas = p_w.to(dtype), f_meas.to(dtype)
    lvl_scale = 1.0 / (2.0 ** level.to(dtype))
    uv_meas = f_meas[:, :2] / f_meas[:, 2:3]
    eye6 = torch.eye(6, dtype=dtype, device=p_w.device)

    def residuals(q, t):
        xyz = _mm(p_w, quat_to_matrix(q).T, low) + t
        ok = valid & (xyz[:, 2] > 1e-2)
        z = torch.where(ok, xyz[:, 2], torch.ones_like(xyz[:, 2]))
        xyz = torch.cat([xyz[:, :2], z[:, None]], 1)
        e = (xyz[:, :2] / xyz[:, 2:3] - uv_meas) * lvl_scale[:, None]
        return torch.where(ok[:, None], e, torch.zeros_like(e)), xyz, ok

    def weighted(q, t, scale):
        e, xyz, ok = residuals(q, t)
        en = torch.linalg.norm(e, dim=-1)
        w = tukey(en / scale) * ok.to(dtype)
        return (w * en * en).sum(), e, xyz, w

    e0, _, ok0 = residuals(q, t)
    if not bool(ok0.any()):
        return q, t
    scale0 = torch.clamp(MAD_NORMALIZER * lower_median(
        torch.linalg.norm(e0, dim=-1)[ok0]), min=1e-7)
    scale_fixed = torch.tensor(0.85 / focal, dtype=dtype,
                               device=p_w.device)
    for it in range(n_iter):
        scale = scale_fixed if it >= 5 else scale0
        chi2, e, xyz, w = weighted(q, t, scale)
        x, y, z = xyz.unbind(-1)
        zero = torch.zeros_like(z)
        dpi = torch.stack([torch.stack([1 / z, zero, -x / z ** 2], -1),
                           torch.stack([zero, 1 / z, -y / z ** 2], -1)], -2)
        dp = torch.cat([torch.eye(3, dtype=dtype, device=p_w.device).expand(
            len(z), 3, 3), -hat(xyz)], -1)
        J = (_mm(dpi, dp, low) * lvl_scale[:, None, None]).reshape(-1, 6)
        wJ = (J.reshape(-1, 2, 6) * w[:, None, None]).reshape(-1, 6)
        H = _mm(wJ.T, J, low)
        g = _mm(wJ.T, e.reshape(-1, 1), low)[:, 0]
        H = H + 1e-6 * eye6 * (torch.diagonal(H).sum() / 6.0 + 1.0)
        dq, dt = se3_exp(torch.linalg.solve(H, -g))
        q_new = quat_mul(dq, q)
        q_new = q_new / torch.linalg.norm(q_new)
        t_new = quat_to_matrix(dq) @ t + dt
        if float(weighted(q_new, t_new, scale)[0]) < float(chi2):
            q, t = q_new, t_new
    return q, t


def pose_gap_px(q_a, t_a, q_b, t_b, p_w, valid, focal: float) -> float:
    """The widest distance, in pixels (`focal` times the unit plane),
    between a valid point's projections under two poses (world to
    frame), over the points in front of both."""
    d = torch.float64
    p = p_w.to(d)
    a = p @ quat_to_matrix(q_a.to(d)).T + t_a.to(d)
    b = p @ quat_to_matrix(q_b.to(d)).T + t_b.to(d)
    ok = valid & (a[:, 2] > 1e-2) & (b[:, 2] > 1e-2)
    if not bool(ok.any()):
        return 0.0
    gap = a[ok, :2] / a[ok, 2:] - b[ok, :2] / b[ok, 2:]
    return float(torch.linalg.norm(gap, dim=-1).max()) * float(focal)
