"""Structure-only optimization of landmark positions (Gauss-Newton or
Levenberg-Marquardt with per-point step acceptance) and its round-robin
scheduling — port of `android_svo_tpu/core/point_opt.py`."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.geometry.camera import project2d
from android_svo_tpu_torch.geometry.linsolve import solve_spd
from android_svo_tpu_torch.geometry.se3 import SE3


def optimize_points(pos, obs_q_kw, obs_t_kw, obs_f, obs_valid, point_valid,
                    n_iter: int, method: str = "gn"):
    """GN on landmark positions (B, 3) against (B, O) observations;
    `method == "lm"` damps each point's diagonal by its own mu (0.01 to
    start, max(mu/3, 1e-8) on accept, x10 on reject).  Returns (pos_new,
    chi2)."""
    lm = method == "lm"
    dtype = pos.dtype
    uv_meas = project2d(obs_f)
    T = SE3(q=obs_q_kw, t=obs_t_kw)
    R = T.rotation_matrix()
    eye3 = torch.eye(3, dtype=dtype, device=pos.device)

    def chi2_of(p):
        xyz = T.apply(p[:, None, :])
        ok = obs_valid & (xyz[..., 2] > 1e-2)
        z = torch.where(ok, xyz[..., 2], torch.ones_like(xyz[..., 2]))
        e = torch.stack([xyz[..., 0] / z, xyz[..., 1] / z], dim=-1) - uv_meas
        e = torch.where(ok[..., None], e, torch.zeros_like(e))
        return torch.sum(e * e, dim=(-2, -1)), e, xyz, ok, z

    p = pos
    mu = (torch.full(pos.shape[:1], 0.01, dtype=dtype, device=pos.device)
          if lm else None)
    for _ in range(n_iter):
        chi2, e, xyz, ok, z = chi2_of(p)
        zi = 1.0 / z
        zi2 = zi * zi
        x, y = xyz[..., 0], xyz[..., 1]
        zero = torch.zeros_like(zi)
        dpi = torch.stack([
            torch.stack([zi, zero, -x * zi2], dim=-1),
            torch.stack([zero, zi, -y * zi2], dim=-1),
        ], dim=-2)
        J = dpi @ R
        J = torch.where(ok[..., None, None], J, torch.zeros_like(J))
        H = torch.einsum("boij,boik->bjk", J, J)
        if lm:
            H = H + mu[:, None, None] * (H * eye3)
        H = H + 1e-8 * eye3
        g = torch.einsum("boij,boi->bj", J, e)
        dx = solve_spd(H, -g)
        p_try = p + dx
        chi2_new = chi2_of(p_try)[0]
        accept = point_valid & (chi2_new < chi2)
        p = torch.where(accept[:, None], p_try, p)
        if lm:
            mu = torch.where(accept, torch.clamp(mu / 3.0, min=1e-8),
                             mu * 10.0)
    return p, chi2_of(p)[0]


def select_points_for_optim(last_optim, valid, n_select: int):
    """The n_select valid points with the oldest last_optim stamp.
    Returns (slots, selected_mask)."""
    key = torch.where(valid, last_optim,
                      torch.full_like(last_optim, torch.iinfo(torch.int32).max))
    order = torch.argsort(key, stable=True)
    slots = order[:n_select]
    return slots, valid[slots]
