"""Map-level utilities — port of `android_svo_tpu/core/map_tools.py`:
re-anchoring the whole map by a similarity (`transform_map`), the
covisibility queries `get_close_keyframes` and `get_furthest_keyframe`, and
the host-side invariant checks and statistics (`map_validation`,
`map_statistics`), all on the port's `VOState`.
"""

from __future__ import annotations

import numpy as np
import torch

from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.geometry.se3 import SE3


def _centres(q, t):
    """Camera centres (world position) of world->camera poses."""
    return SE3(q=q, t=t).inverse().t


def transform_map(vo: st.VOState, R, t, s=1.0) -> st.VOState:
    """Re-anchor the map by the similarity x_new = s R x_old + t: landmark
    positions move with it, every keyframe's and the last frame's camera
    centre moves with it and their rotations compose with R^T, and the
    depth filter's metric quantities scale (inverse-depth mean / s,
    variance / s^2, range * s, scene depth * s)."""
    dtype = vo.points.pos.dtype
    s = torch.as_tensor(s, dtype=dtype, device=vo.points.pos.device)
    pts = vo.points.replace(pos=s * (vo.points.pos @ R.T) + t)
    T_old_new = SE3.from_rt(R.T, -(R.T @ t) / s)

    def remap(q, tt):
        q_new = SE3(q=q, t=tt).compose(T_old_new).q
        R_new = SE3(q=q_new, t=torch.zeros_like(tt)).rotation_matrix()
        c_new = s * (_centres(q, tt) @ R.T) + t
        return q_new, -torch.einsum("...ij,...j->...i", R_new, c_new)

    q_kw, t_kw = remap(vo.kfs.q_kw, vo.kfs.t_kw)
    kfs = vo.kfs.replace(q_kw=q_kw, t_kw=t_kw,
                         scene_depth=vo.kfs.scene_depth * s)
    q_fw, t_fw = remap(vo.last.q_fw, vo.last.t_fw)
    last = vo.last.replace(q_fw=q_fw, t_fw=t_fw)
    seeds = vo.seeds.replace(mu=vo.seeds.mu / s,
                             sigma2=vo.seeds.sigma2 / (s * s),
                             z_range=vo.seeds.z_range * s)
    return vo.replace(points=pts, kfs=kfs, last=last, seeds=seeds)


def get_close_keyframes(vo: st.VOState, T_cw: SE3, cam) -> torch.Tensor:
    """Distances (K,) from the current camera to each valid keyframe that
    shares its field of view (one of the keyframe's features, placed at its
    scene depth, projects into the current image), +inf for the others."""
    cur_pos = T_cw.inverse().t
    kfs = vo.kfs
    dist = torch.linalg.norm(_centres(kfs.q_kw, kfs.t_kw) - cur_pos, dim=-1)
    T_wk = SE3(q=kfs.q_kw[:, None], t=kfs.t_kw[:, None]).inverse()
    p_w = T_wk.apply(kfs.ftr_f * kfs.scene_depth[:, None, None])
    p_c = T_cw.apply(p_w)
    uv = cam.world2cam(p_c)
    inside = ((p_c[..., 2] > 0) & (uv[..., 0] >= 0) & (uv[..., 1] >= 0)
              & (uv[..., 0] < cam.width) & (uv[..., 1] < cam.height))
    overlaps = torch.any(inside & kfs.ftr_valid, dim=-1)
    return torch.where(kfs.valid & overlaps, dist,
                       torch.full_like(dist, float("inf")))


def get_furthest_keyframe(vo: st.VOState, pos) -> torch.Tensor:
    """Slot (int32) of the valid keyframe furthest from `pos`; -1 if there
    is no valid keyframe."""
    kfs = vo.kfs
    dist = torch.linalg.norm(_centres(kfs.q_kw, kfs.t_kw) - pos, dim=-1)
    dist = torch.where(kfs.valid, dist, torch.full_like(dist, -float("inf")))
    k = torch.argmax(dist).to(torch.int32)
    return torch.where(torch.any(kfs.valid), k, torch.full_like(k, -1))


def _np(x):
    return x.detach().cpu().numpy()


def map_validation(vo: st.VOState, dims) -> dict:
    """Arena invariant checks.  Returns {name: count of violations}; all
    zeros on a healthy state.  Runs on the host."""
    kfs, pts = vo.kfs, vo.points
    K = kfs.valid.shape[0]
    P = pts.pos.shape[0]
    kf_valid = _np(kfs.valid)
    ftr_valid = _np(kfs.ftr_valid)
    ftr_point = _np(kfs.ftr_point)
    obs_kf = _np(pts.obs_kf)
    obs_count = _np(pts.obs_count)
    pt_valid = _np(pts.ptype) != st.TYPE_DELETED

    errs = {}
    # features on invalid keyframes must be masked out
    errs["ftr_on_invalid_kf"] = int((ftr_valid & ~kf_valid[:, None]).sum())
    # a feature's landmark id must reference a live point
    linked = ftr_valid & (ftr_point >= 0)
    ok = np.zeros_like(linked)
    ok[linked] = pt_valid[np.clip(ftr_point[linked], 0, P - 1)]
    errs["ftr_to_deleted_point"] = int((linked & ~ok).sum())
    # every live observation slot must name a live keyframe
    O = obs_kf.shape[1]
    live_obs = (np.arange(O)[None, :] < obs_count[:, None]) & pt_valid[:, None]
    bad = np.zeros_like(live_obs)
    sel = live_obs & (obs_kf >= 0)
    bad[sel] = ~kf_valid[np.clip(obs_kf[sel], 0, K - 1)]
    errs["obs_on_invalid_kf"] = int(bad.sum())
    errs["obs_negative_slot"] = int((live_obs & (obs_kf < 0)).sum())
    # seeds must belong to live keyframes
    seed_valid = _np(vo.seeds.valid)
    seed_kf = _np(vo.seeds.kf)
    errs["seed_on_invalid_kf"] = int(
        (seed_valid & ~kf_valid[np.clip(seed_kf, 0, K - 1)]).sum())
    errs["nonfinite_point_pos"] = int(
        (~np.isfinite(_np(pts.pos)).all(axis=-1) & pt_valid).sum())
    return errs


def map_statistics(vo: st.VOState) -> dict:
    """Aggregate map statistics (keyframes, points by type, seeds, features
    per keyframe, observations per point).  Runs on the host."""
    kf_valid = _np(vo.kfs.valid)
    ftr_valid = _np(vo.kfs.ftr_valid)
    ptype = _np(vo.points.ptype)
    obs_count = _np(vo.points.obs_count)
    pt_valid = ptype != st.TYPE_DELETED
    n_kf = int(kf_valid.sum())
    n_pts = int(pt_valid.sum())
    return {
        "n_keyframes": n_kf,
        "n_points": n_pts,
        "n_candidates": int((ptype == st.TYPE_CANDIDATE).sum()),
        "n_good": int((ptype == st.TYPE_GOOD).sum()),
        "n_seeds": int(_np(vo.seeds.valid).sum()),
        "avg_fts_per_kf": float(ftr_valid[kf_valid].sum(axis=-1).mean())
        if n_kf else 0.0,
        "avg_obs_per_point": float(obs_count[pt_valid].mean())
        if n_pts else 0.0,
    }
