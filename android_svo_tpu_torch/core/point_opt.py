"""Structure-only optimization of landmark positions (Gauss-Newton or
Levenberg-Marquardt with per-point step acceptance) and its round-robin
scheduling — port of `android_svo_tpu/core/point_opt.py` — and the tracking
step's stage that runs them (`optimize_structure`)."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core.scatter import set_rows
from android_svo_tpu_torch.geometry.camera import project2d
from android_svo_tpu_torch.geometry.linsolve import solve_spd
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import point_gn
from android_svo_tpu_torch.ops.cuda_build import (batch_first, call_op,
                                                  cfg_use_pallas, on_card,
                                                  use_kernels)


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


def optimize_structure(points, kfs, frame_id, cfg: SVOConfig):
    """STEP 4 of the tracking step: the `structureoptim_max_pts` live
    landmarks of two or more observations optimised longest ago
    (`select_points_for_optim`), each refined by `optimize_points` against
    its observations from live keyframes, and stamped with `frame_id`.
    Returns the point arena with new `pos` and `last_optim`.

    On CUDA tensors (with `cfg.use_pallas`) everything after the selection
    is one launch of `point_gn_kernel` (`ops/point_gn.py`); on CPU tensors,
    or with `use_pallas` off, it is `optimize_selected_plain`.  There is no
    fallback.  Under `torch.func.vmap` the call is the op
    `svo_torch::point_gn`, whose vmap rule makes the batch one launch;
    outside a `torch.func` transform the op's body is called directly
    (`call_op`)."""
    slots, sel = select_points_for_optim(
        points.last_optim, points.valid & (points.obs_count >= 2),
        cfg.structureoptim_max_pts)
    pos, last_optim = call_op(
        _op, _body, points.pos, points.last_optim, points.obs_kf,
        points.obs_f, kfs.q_kw, kfs.t_kw, kfs.valid, slots, sel, frame_id,
        int(cfg.structureoptim_n_iter), cfg.structureoptim_method == "lm",
        use_kernels(cfg_use_pallas(cfg)))
    return points.replace(pos=pos, last_optim=last_optim)


def optimize_selected_plain(pos, last_optim, obs_kf, obs_f, q_kw, t_kw,
                            kf_valid, slots, sel, frame_id, n_iter: int,
                            lm: bool):
    """The plain version of `point_gn_kernel` and `optimize_structure`'s
    CPU path: the selected slots' rows and their observations' keyframe
    poses gathered, `optimize_points` (`lm`: the "lm" method), and the
    arena's `pos` and `last_optim` with the selected rows rewritten (the
    refined position, the frame's stamp) as new tensors."""
    okf = obs_kf[slots]
    ks = torch.clamp(okf, min=0).to(torch.int64)
    obs_ok = (okf >= 0) & kf_valid[ks]
    pos_new, _ = optimize_points(
        pos[slots], q_kw[ks], t_kw[ks], obs_f[slots], obs_ok, sel, n_iter,
        method="lm" if lm else "gn")
    return (set_rows(pos, slots, torch.where(sel[:, None], pos_new,
                                             pos[slots])),
            set_rows(last_optim, slots, torch.where(sel, frame_id,
                                                    last_optim[slots])))


def _body(pos, last_optim, obs_kf, obs_f, q_kw, t_kw, kf_valid, slots, sel,
          frame_id, n_iter, lm, use_pallas):
    if on_card(pos, use_pallas):
        return point_gn.point_gn(pos, last_optim, obs_kf, obs_f, q_kw, t_kw,
                                 kf_valid, slots, sel, frame_id, n_iter, lm)
    return optimize_selected_plain(pos, last_optim, obs_kf, obs_f, q_kw,
                                   t_kw, kf_valid, slots, sel, frame_id,
                                   n_iter, lm)


_op = torch.library.custom_op(
    "svo_torch::point_gn", _body, mutates_args=(),
    schema="(Tensor pos, Tensor last_optim, Tensor obs_kf, Tensor obs_f, "
           "Tensor q_kw, Tensor t_kw, Tensor kf_valid, Tensor slots, "
           "Tensor sel, Tensor frame_id, int n_iter, bool lm, "
           "bool use_pallas) -> (Tensor, Tensor)")


@_op.register_vmap
def _vmap(info, in_dims, pos, last_optim, obs_kf, obs_f, q_kw, t_kw,
          kf_valid, slots, sel, frame_id, n_iter, lm, use_pallas):
    """The batch as one launch of B blocks on the card; on the CPU the
    plain version frame by frame (a vmap rule cannot open another
    `torch.func.vmap`), bit for bit the single calls either way."""
    B = info.batch_size
    args = [batch_first(x, d, B) for x, d in zip(
        (pos, last_optim, obs_kf, obs_f, q_kw, t_kw, kf_valid, slots, sel,
         frame_id), in_dims)]
    if on_card(pos, use_pallas):
        out = point_gn.point_gn_batched(*args, n_iter, lm)
    else:
        frames = [_body(*(a[b] for a in args), n_iter, lm, False)
                  for b in range(B)]
        out = tuple(torch.stack(o) for o in zip(*frames))
    return out, (0, 0)
