"""Motion-only bundle adjustment (pose Gauss-Newton or Levenberg-Marquardt
with Tukey weights and trust-region step acceptance) — port of
`android_svo_tpu/core/pose_opt.py`."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.geometry import robust
from android_svo_tpu_torch.geometry.camera import project2d
from android_svo_tpu_torch.geometry.linsolve import inv_spd, solve_spd
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import pose_gn
from android_svo_tpu_torch.ops.cuda_build import (batch_first, call_op,
                                                  cfg_use_pallas, on_card,
                                                  use_kernels)
from android_svo_tpu_torch.ops.reduce import fixed_sum
from android_svo_tpu_torch.ops.sparse_align import _geo_jacobian


def optimize_pose(T_fw_init: SE3, p_w, f_meas, level, valid, focal,
                  cfg: SVOConfig):
    """Refine a frame pose against its matched 3D points.  Returns
    (T_fw, inlier_mask, n_inliers, cov, chi2_init, chi2_final).

    `cfg.poseoptim_method == "lm"` scales the normal equations' diagonal by
    (1 + mu), mu starting at 0.01, relaxing to max(mu/3, 1e-8) on an
    accepted step and growing tenfold on a rejected one; any other method
    is Gauss-Newton, as in the JAX package.

    On CUDA tensors (with `cfg.use_pallas`) the whole refinement is one
    launch of `pose_gn_kernel` (`ops/pose_gn.py`); on CPU tensors, or with
    `use_pallas` off, it is `optimize_pose_plain`.  There is no fallback.
    Under `torch.func.vmap` the call is the op `svo_torch::pose_gn`, whose
    vmap rule makes the batch one launch; outside a `torch.func` transform
    the op's body is called directly (`call_op`)."""
    q, t, *rest = call_op(
        _op, _body, T_fw_init.q, T_fw_init.t, p_w, f_meas, level, valid,
        focal, int(cfg.poseoptim_n_iter), float(cfg.poseoptim_thresh),
        cfg.poseoptim_method == "lm", use_kernels(cfg_use_pallas(cfg)))
    return (SE3(q=q, t=t), *rest)


def _body(q, t, p_w, f_meas, level, valid, focal, n_iter, thresh, lm,
          use_pallas):
    if on_card(p_w, use_pallas):
        return pose_gn.pose_gn(q, t, p_w, f_meas, level, valid, focal,
                               n_iter, thresh, lm)
    T, *rest = optimize_pose_plain(SE3(q=q, t=t), p_w, f_meas, level, valid,
                                   focal, n_iter, thresh, lm)
    if n_iter == 0:                # the start itself; an op returns no input
        return (T.q.clone(), T.t.clone(), *rest)
    return (T.q, T.t, *rest)


_op = torch.library.custom_op(
    "svo_torch::pose_gn", _body, mutates_args=(),
    schema="(Tensor q, Tensor t, Tensor p_w, Tensor f_meas, Tensor level, "
           "Tensor valid, Tensor focal, int n_iter, float thresh, bool lm, "
           "bool use_pallas) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
           "Tensor, Tensor)")


@_op.register_vmap
def _vmap(info, in_dims, q, t, p_w, f_meas, level, valid, focal, n_iter,
          thresh, lm, use_pallas):
    """The batch as one launch of B blocks on the card; on the CPU the
    plain version frame by frame (a vmap rule cannot open another
    `torch.func.vmap`), bit for bit the single calls either way."""
    B = info.batch_size
    args = [batch_first(x, d, B) for x, d in
            zip((q, t, p_w, f_meas, level, valid, focal), in_dims)]
    if on_card(p_w, use_pallas):
        out = pose_gn.pose_gn_batched(*args, n_iter, thresh, lm)
    else:
        frames = [_body(*(a[b] for a in args), n_iter, thresh, lm, False)
                  for b in range(B)]
        out = tuple(torch.stack(o) for o in zip(*frames))
    return out, (0,) * 7


def optimize_pose_plain(T_fw_init: SE3, p_w, f_meas, level, valid, focal,
                        n_iter: int, thresh: float, lm: bool):
    """The plain version of `pose_gn_kernel` and `optimize_pose`'s CPU
    path (`n_iter`, `thresh` and `lm` are `cfg.poseoptim_n_iter`,
    `poseoptim_thresh` and whether the method is "lm")."""
    dtype = p_w.dtype
    dev = p_w.device
    lvl_scale = 1.0 / (2.0 ** level.to(dtype))
    uv_meas = project2d(f_meas)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def residuals(T: SE3):
        xyz_f = T.apply(p_w)
        ok = valid & (xyz_f[..., 2] > 1e-2)
        z_safe = torch.where(ok, xyz_f[..., 2], torch.ones_like(xyz_f[..., 2]))
        xyz_safe = torch.cat([xyz_f[..., :2], z_safe[..., None]], dim=-1)
        e = (project2d(xyz_safe) - uv_meas) * lvl_scale[:, None]
        e = torch.where(ok[:, None], e, torch.zeros_like(e))
        return e, xyz_safe, ok

    e0, _, ok0 = residuals(T_fw_init)
    enorm0 = torch.linalg.norm(e0, dim=-1)
    scale0 = torch.clamp(robust.mad_scale(enorm0, ok0), min=1e-7)
    chi2_init = fixed_sum(enorm0 * enorm0, 1)
    scale_fixed = (0.85 / focal).to(dtype)

    def weighted_chi2(T: SE3, it_scale):
        e, xyz_f, ok = residuals(T)
        enorm = torch.linalg.norm(e, dim=-1)
        w = robust.tukey_weight(enorm / it_scale) * ok.to(dtype)
        return fixed_sum(w * enorm * enorm, 1), e, xyz_f, ok, w

    def normal_eq(xyz_f, w):
        J = _geo_jacobian(xyz_f) * lvl_scale[:, None, None]
        Jw = J * w[:, None, None]
        # the normal equations' sums in a fixed order (ops/reduce.py): the
        # batched step rounds them as each sequence's single step does
        return J, Jw, fixed_sum(Jw[..., :, None] * J[..., None, :], 2)

    q, t = T_fw_init.q, T_fw_init.t
    # LM damping; nothing is made for GN (no device work on the default path)
    mu = torch.tensor(0.01, dtype=dtype, device=dev) if lm else None
    for it in range(n_iter):
        # Tukey scale re-seated at ~1 px from iteration 5 on
        it_scale = scale_fixed if it >= 5 else scale0
        T = SE3(q=q, t=t)
        chi2, e, xyz_f, ok, w = weighted_chi2(T, it_scale)
        J, Jw, H = normal_eq(xyz_f, w)
        g = fixed_sum(Jw * e[..., None], 2)
        if lm:
            H = H + mu * torch.diag(torch.diag(H))
        H = H + 1e-6 * eye6 * (torch.diagonal(H).sum() / 6.0 + 1.0)
        dx = solve_spd(H, -g)
        T_new = SE3.exp(dx).compose(T).normalize()
        chi2_new = weighted_chi2(T_new, it_scale)[0]
        accept = chi2_new < chi2
        q = torch.where(accept, T_new.q, q)
        t = torch.where(accept, T_new.t, t)
        if lm:
            mu = torch.where(accept, torch.clamp(mu / 3.0, min=1e-8),
                             mu * 10.0)
    scale = scale_fixed if n_iter > 5 else scale0
    T_out = SE3(q=q, t=t)

    e, xyz_f, ok = residuals(T_out)
    enorm = torch.linalg.norm(e, dim=-1)
    inlier = ok & (enorm < thresh / focal)
    w = robust.tukey_weight(enorm / scale) * ok.to(dtype)
    _, _, H = normal_eq(xyz_f, w)
    H = H + 1e-6 * eye6 * (torch.diagonal(H).sum() / 6.0 + 1.0)
    cov = inv_spd(H)
    chi2_final = fixed_sum(enorm * enorm, 1)
    return (T_out, inlier, torch.sum(inlier).to(torch.int32), cov,
            chi2_init, chi2_final)
