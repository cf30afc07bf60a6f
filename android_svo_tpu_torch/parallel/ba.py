"""Local bundle adjustment by Schur complement — port of
`android_svo_tpu/parallel/ba.py`: `local_ba` on one device,
`make_sharded_ba` with the landmark axis split over the mesh's "map" ranks,
and `select_core_keyframes`.

Gauss-Newton over the core keyframe window with Huber weights on unit-plane
reprojection residuals.  Every per-landmark block (U_p, its inverse, the
G_pc cross blocks) is computed independently per landmark; the reduced
camera system is a sum over the landmark axis, then one dense (6 NC)^2
solve:
    S = H_cc - H_cp H_pp^-1 H_pc;   rhs = -b_c + H_cp H_pp^-1 b_p
    S dx_c = rhs;   dx_p = -H_pp^-1 (b_p + H_pc dx_c)
One iteration is three parts (spans `local_ba.partials`, `local_ba.solve`
and `local_ba.update`): the per-landmark partial sums, the replicated
reduced solve, and the landmarks' back-substitution; sharded, the partial
sums are summed over the landmark shards in between.  Counter
`local_ba_iters` adds `loba_n_iter` a call.
The einsums run in full fp32 (the package disables TF32 at import).

With `cfg.loba_fix_neighbour_kfs` the residuals follow upstream SVO's
`ba::localBA`: every observation of a landmark made by a valid keyframe
enters, and a keyframe outside the core window enters as a fixed camera.
Its observations add to the landmark blocks (U_p, b_p) and to chi2 and,
the core one-hot being zero there, to no camera block, so the landmarks
stay tied to cameras that do not move, which holds the monocular scale.
Without it (the JAX package's rule) only the core keyframes' observations
enter, and the one fixed core camera leaves the scale free.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.geometry import robust
from android_svo_tpu_torch.geometry.camera import project2d
from android_svo_tpu_torch.geometry.linsolve import inv_spd, solve_spd_loop
from android_svo_tpu_torch.geometry.se3 import SE3, hat
from android_svo_tpu_torch.utils import profiling


def local_ba(pos: torch.Tensor, point_valid: torch.Tensor,
             obs_kf: torch.Tensor, obs_f: torch.Tensor,
             q_kw: torch.Tensor, t_kw: torch.Tensor,
             core_slots: torch.Tensor, fixed: torch.Tensor,
             focal, cfg: SVOConfig, kf_valid: torch.Tensor | None = None):
    """Jointly refine core keyframe poses and landmark positions.

    Args:
      pos: (P, 3) landmark positions (world).
      point_valid: (P,) landmarks to include.
      obs_kf: (P, O) keyframe slot of each observation (-1 = empty).
      obs_f: (P, O, 3) measured unit bearings.
      q_kw/t_kw: (K, 4)/(K, 3) keyframe poses (world->kf).
      core_slots: (NC,) keyframe slots being optimised.
      fixed: (NC,) gauge mask — fixed cameras receive no update.
      focal: focal length for the Huber width conversion.
      kf_valid: (K,) live keyframe slots; with `cfg.loba_fix_neighbour_kfs`
        the observations of the others are left out (None: every slot).

    Returns (q_kw', t_kw', pos', chi2) — poses updated at core_slots only.
    """
    return _run_ba(pos, point_valid, obs_kf, obs_f, q_kw, t_kw, core_slots,
                   fixed, focal, cfg, reduce=None, kf_valid=kf_valid)


def _run_ba(pos, point_valid, obs_kf, obs_f, q_kw, t_kw, core_slots, fixed,
            focal, cfg: SVOConfig, reduce, kf_valid=None):
    """The GN loop; `reduce` (None on one device) sums the per-landmark
    partial sums over the landmark shards, once per iteration."""
    huber_width = cfg.loba_robust_huber_width / focal
    core_slots = core_slots.to(torch.int64)
    is_core = obs_kf[:, :, None] == core_slots[None, None, :]  # (P,O,NC)
    if cfg.loba_fix_neighbour_kfs:
        # every live keyframe's observation; those outside the core are
        # fixed cameras (Ehot is zero there)
        seen = obs_kf >= 0
        if kf_valid is not None:
            seen = seen & kf_valid[torch.clamp(obs_kf, min=0).to(torch.int64)]
    else:
        seen = torch.any(is_core, dim=-1) & (obs_kf >= 0)
    obs_ok = seen & point_valid[:, None]
    Ehot = is_core.to(pos.dtype)
    chi2 = None
    profiling.count("local_ba_iters", cfg.loba_n_iter)
    for _ in range(cfg.loba_n_iter):
        with profiling.span("local_ba.partials"):
            sums, local = _ba_partials(pos, obs_f, obs_ok, Ehot, q_kw, t_kw,
                                       obs_kf, huber_width)
            if reduce is not None:
                sums = reduce(sums)
        Hcc, bc, S_red, rhs_red, chi2 = sums
        with profiling.span("local_ba.solve"):
            dxc = _ba_solve(Hcc, bc, S_red, rhs_red, fixed)
        with profiling.span("local_ba.update"):
            q_kw, t_kw, pos = _ba_update(pos, point_valid, local, dxc, q_kw,
                                         t_kw, core_slots)
    return q_kw, t_kw, pos, chi2


def _ba_partials(pos, obs_f, obs_ok, Ehot, q_kw, t_kw, obs_kf, huber_width):
    """The per-landmark part of one GN iteration: the reduced camera
    system's sums over this set of landmarks (Hcc, bc, S_red, rhs_red and
    chi2, which add over landmark shards) and what the landmarks' own
    back-substitution needs (ok, G, Upp_inv, bp)."""
    dtype = pos.dtype
    kf_idx = torch.clamp(obs_kf, min=0).to(torch.int64)
    T = SE3(q=q_kw[kf_idx], t=t_kw[kf_idx])                  # (P,O) poses
    xyz = T.apply(pos[:, None, :])                           # (P,O,3)
    # depth gate: an observation almost at the camera plane gives
    # zi^2-scale Jacobians that overflow the fp32 Schur algebra
    ok = obs_ok & (xyz[..., 2] > 1e-2)
    z = torch.where(ok, xyz[..., 2], torch.ones_like(xyz[..., 2]))
    x, y = xyz[..., 0], xyz[..., 1]
    uv_meas = project2d(obs_f)
    e = torch.stack([x / z, y / z], dim=-1) - uv_meas        # (P,O,2)
    e = torch.where(ok[..., None], e, torch.zeros_like(e))
    enorm = torch.linalg.norm(e, dim=-1)
    w = robust.huber_weight(enorm / torch.clamp(
        torch.as_tensor(huber_width, dtype=dtype, device=pos.device),
        min=1e-12))
    w = w * ok.to(dtype)
    chi2 = torch.sum(w * enorm * enorm)

    zi = 1.0 / z
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    dpi = torch.stack([torch.stack([zi, zero, -x * zi2], dim=-1),
                       torch.stack([zero, zi, -y * zi2], dim=-1)],
                      dim=-2)                                # (P,O,2,3)
    R = T.rotation_matrix()                                  # (P,O,3,3)
    Jp = dpi @ R                                             # d/dpos
    eye = torch.eye(3, dtype=dtype, device=pos.device).expand(
        xyz.shape + (3,))
    Jc = dpi @ torch.cat([eye, -hat(xyz)], dim=-1)           # (P,O,2,6)
    okm = ok[..., None, None]
    Jp = torch.where(okm, Jp, torch.zeros_like(Jp))
    Jc = torch.where(okm, Jc, torch.zeros_like(Jc))
    wJp = w[..., None, None] * Jp
    wJc = w[..., None, None] * Jc

    # landmark blocks
    Upp = torch.einsum("poij,poik->pjk", wJp, Jp)            # (P,3,3)
    Upp = Upp + 1e-5 * torch.eye(3, dtype=dtype, device=pos.device)
    bp = torch.einsum("poij,poi->pj", wJp, e)                # (P,3)
    Upp_inv = inv_spd(Upp)

    # camera blocks, scattered to core index by the one-hot
    Hcc = torch.einsum("poc,poij,poik->cjk", Ehot, wJc, Jc)  # (NC,6,6)
    bc = torch.einsum("poc,poij,poi->cj", Ehot, wJc, e)      # (NC,6)

    # cross terms: Y_po = Jc^T W Jp (6,3); G_pc = sum_o E Y
    Y = torch.einsum("poij,poik->pojk", wJc, Jp)             # (P,O,6,3)
    G = torch.einsum("poc,pojk->pcjk", Ehot, Y)              # (P,NC,6,3)

    # Schur reduction over the landmark axis (the sum a sharded landmark
    # axis reduces across ranks)
    GU = torch.einsum("pcjk,pkl->pcjl", G, Upp_inv)          # (P,NC,6,3)
    S_red = torch.einsum("pcjl,pdml->cdjm", GU, G)           # (NC,NC,6,6)
    rhs_red = torch.einsum("pcjl,pl->cj", GU, bp)            # (NC,6)
    return (Hcc, bc, S_red, rhs_red, chi2), (ok, G, Upp_inv, bp)


def _ba_solve(Hcc, bc, S_red, rhs_red, fixed):
    """The reduced camera system's solve (replicated): the dense Schur
    complement, gauge fixing, the trace regulariser, the explicit Cholesky
    and the fp32 safety net.  Returns the camera updates dx_c (NC, 6)."""
    NC = Hcc.shape[0]
    S = _to_dense(Hcc, NC) - _cross_to_dense(S_red, NC)
    rhs = (-bc + rhs_red).reshape(NC * 6)

    # gauge fixing: zero rows/cols of fixed cameras, unit diagonal
    fix = torch.repeat_interleave(fixed, 6)
    S = torch.where(fix[:, None] | fix[None, :], torch.zeros_like(S), S)
    damp = 1e-6 * (torch.trace(S) / (6 * NC) + 1.0)
    S = S + torch.diag(torch.where(fix, torch.ones_like(rhs),
                                   damp.expand_as(rhs)))
    dxc = solve_spd_loop(S, rhs)
    dxc = torch.where(fix, torch.zeros_like(dxc), dxc).reshape(NC, 6)
    # fp32 safety net: a badly conditioned reduced system degrades to "no
    # update" instead of poisoning the keyframe arena
    cam_ok = (torch.all(torch.isfinite(dxc), dim=-1)
              & (torch.linalg.norm(dxc, dim=-1) < 10.0))
    return torch.where(cam_ok[:, None], dxc, torch.zeros_like(dxc))


def _ba_update(pos, point_valid, local, dxc, q_kw, t_kw, core_slots):
    """Back-substitute this set of landmarks and apply the camera updates:
    dx_p = -Upp^-1 (bp + H_pc dx_c); T_kw <- exp(dx_c) o T_kw."""
    ok, G, Upp_inv, bp = local
    Hpc_dxc = torch.einsum("pcjk,cj->pk", G, dxc)            # (P,3)
    dxp = -torch.einsum("pkl,pl->pk", Upp_inv, bp + Hpc_dxc)
    has_obs = torch.any(ok, dim=1)
    step_ok = (torch.all(torch.isfinite(dxp), dim=-1)
               & (torch.linalg.norm(dxp, dim=-1)
                  < 1.0 + torch.linalg.norm(pos, dim=-1)))
    pos_new = torch.where((point_valid & has_obs & step_ok)[:, None],
                          pos + dxp, pos)

    # the core slots are distinct
    T_core = SE3(q=q_kw[core_slots], t=t_kw[core_slots])
    T_new = SE3.exp(dxc).compose(T_core).normalize()
    q_out = q_kw.clone()
    t_out = t_kw.clone()
    q_out[core_slots] = T_new.q
    t_out[core_slots] = T_new.t
    return q_out, t_out, pos_new


def _to_dense(Hcc: torch.Tensor, NC: int) -> torch.Tensor:
    """Block-diagonal (NC,6,6) -> (NC*6, NC*6)."""
    S = torch.zeros((NC, 6, NC, 6), dtype=Hcc.dtype, device=Hcc.device)
    for c in range(NC):
        S[c, :, c, :] = Hcc[c]
    return S.reshape(NC * 6, NC * 6)


def _cross_to_dense(S_red: torch.Tensor, NC: int) -> torch.Tensor:
    """(NC,NC,6,6) -> (NC*6, NC*6)."""
    return S_red.permute(0, 2, 1, 3).reshape(NC * 6, NC * 6)


def make_sharded_ba(cfg: SVOConfig, focal, mesh):
    """`local_ba` with the landmark axis split over the mesh's "map" axis
    (JAX `make_sharded_ba`).

    Returns fn(pos, valid, obs_kf, obs_f, q_kw, t_kw, core, fixed) ->
    (q', t', pos', chi2): every rank passes its own block of landmarks
    (pos, valid, obs_kf, obs_f) and the same keyframe poses, core window
    and gauge mask, and gets its block's pos' and the replicated poses and
    chi2.  Each Gauss-Newton iteration sums the reduced camera system's
    partial sums (Hcc, bc, S_red, rhs_red, chi2: 36 NC^2 + 48 NC + 1
    float32, 4,564 bytes at NC = 5) over the "map" group in ONE fused
    `all_reduce` (`mesh_lib.all_reduce_sum`); the solve and the trace
    regulariser follow on every rank, then each back-substitutes its own
    landmarks."""
    from android_svo_tpu_torch.parallel import mesh as mesh_lib
    group = mesh.get_group(mesh_lib.MAP_AXIS)

    def reduce(sums):
        Hcc, bc, S_red, rhs_red, chi2 = sums
        parts = (Hcc, bc, S_red, rhs_red, chi2.reshape(1))
        buf = mesh_lib.all_reduce_sum(
            torch.cat([x.reshape(-1) for x in parts]), group)
        out, off = [], 0
        for x in parts:
            out.append(buf[off:off + x.numel()].reshape(x.shape))
            off += x.numel()
        out[-1] = out[-1].reshape(())
        return tuple(out)

    def fn(pos, point_valid, obs_kf, obs_f, q_kw, t_kw, core_slots, fixed):
        return _run_ba(pos, point_valid, obs_kf, obs_f, q_kw, t_kw,
                       core_slots, fixed, focal, cfg, reduce=reduce)

    return fn


def select_core_keyframes(q_kw, t_kw, kf_valid, T_cw: SE3, n_core: int):
    """The n_core closest valid keyframes to the current camera.  Returns
    (core_slots (n_core,) int64, fixed (n_core,) bool) — the farthest valid
    selected keyframe is the gauge anchor; invalid slots are fixed too."""
    cam_pos = T_cw.inverse().t
    kf_pos = SE3(q=q_kw, t=t_kw).inverse().t
    dist = torch.linalg.norm(kf_pos - cam_pos, dim=-1)
    dist = torch.where(kf_valid, dist, torch.full_like(dist, float("inf")))
    order = torch.argsort(dist, stable=True)
    core = order[:n_core]
    valid_core = torch.isfinite(dist[core])
    ranks = torch.arange(core.shape[0], device=dist.device)
    far_rank = torch.max(torch.where(valid_core, ranks,
                                     torch.full_like(ranks, -1)))
    fixed = (ranks == far_rank) | ~valid_core
    return core, fixed
