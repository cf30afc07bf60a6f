"""Map reprojection: project landmarks into the current frame, pick one
candidate per grid cell, and match it by direct alignment against its
cached warped patch — port of `android_svo_tpu/core/reprojector.py`."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.core.scatter import (add_rows, compact, set_rows)
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import interp, matcher
from android_svo_tpu_torch.ops.detect import cell_index

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min


def _take_obs(a: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """a[p, best[p]] for a (P, O, ...) table."""
    idx = best.reshape((best.shape[0], 1) + (1,) * (a.dim() - 2))
    idx = idx.expand((best.shape[0], 1) + tuple(a.shape[2:]))
    return torch.gather(a, 1, idx)[:, 0]


def closest_view_obs(pts: st.PointArena, kfs: st.KeyframeArena,
                     cam_pos_w: torch.Tensor, cfg: SVOConfig):
    """Per-point closest-view observation.  Returns (src_kf, src_px,
    src_level, src_f, angle_ok); falls back to the birth anchor when the
    observation table is empty."""
    K = kfs.q_kw.shape[0]
    dir_cur = pts.pos - cam_pos_w[None, :]
    dir_cur = dir_cur / torch.clamp(
        torch.linalg.norm(dir_cur, dim=-1, keepdim=True), min=1e-9)
    ks = torch.clamp(pts.obs_kf, 0, K - 1).to(torch.int64)
    obs_cam_pos = _kf_cam_pos(kfs, slice(None))[ks]
    dir_obs = pts.pos[:, None, :] - obs_cam_pos
    dir_obs = dir_obs / torch.clamp(
        torch.linalg.norm(dir_obs, dim=-1, keepdim=True), min=1e-9)
    # products and a 3-term sum (a batched matrix product rounds
    # differently with a leading batch)
    cosang = (dir_obs * dir_cur[:, None, :]).sum(-1)
    obs_ok = (pts.obs_kf >= 0) & kfs.valid[ks]
    cosang = torch.where(obs_ok, cosang, torch.full_like(cosang,
                                                         float("-inf")))
    best = torch.argmax(cosang, dim=-1)
    best_cos = torch.gather(cosang, 1, best[:, None])[:, 0]
    have_obs = torch.any(obs_ok, dim=-1)

    src_kf = torch.where(have_obs, _take_obs(pts.obs_kf, best), pts.ref_kf)
    src_px = torch.where(have_obs[:, None], _take_obs(pts.obs_px, best),
                         pts.ref_px)
    src_level = torch.where(have_obs, _take_obs(pts.obs_level, best),
                            pts.ref_level)
    src_f = torch.where(have_obs[:, None], _take_obs(pts.obs_f, best),
                        pts.ref_f)
    angle_ok = torch.where(have_obs, best_cos > cfg.max_view_angle_cos,
                           torch.ones_like(have_obs))
    return src_kf, src_px, src_level, src_f, angle_ok


def keyframe_overlap(vo: st.VOState, T_cw: SE3, cam,
                     cfg: SVOConfig) -> torch.Tensor:
    """(K,) count of each keyframe's landmarks visible in the current
    frame."""
    kfs = vo.kfs
    pts = vo.points
    pid = torch.clamp(kfs.ftr_point, min=0).to(torch.int64)
    pos = pts.pos[pid]
    ok = (kfs.ftr_valid & (kfs.ftr_point >= 0) & pts.valid[pid]
          & kfs.valid[:, None])
    xyz = T_cw.apply(pos.reshape(-1, 3)).reshape(pos.shape)
    in_front = xyz[..., 2] > 1e-3
    z_safe = torch.where(in_front, xyz[..., 2], torch.ones_like(xyz[..., 2]))
    px = cam.world2cam(torch.cat([xyz[..., :2], z_safe[..., None]], -1))
    vis = ok & in_front & interp.in_bounds(
        px.reshape(-1, 2), cam.height, cam.width,
        cfg.patch_halfsize + 2).reshape(ok.shape)
    return torch.sum(vis, dim=-1).to(torch.int32)


def reproject_map(vo: st.VOState, cur_stack, T_cw: SE3, cam,
                  cfg: SVOConfig, dims):
    """Returns (features, points', n_matches): the per-cell match table of
    the current frame and the points with updated quality counters."""
    pts = vo.points
    P = pts.pos.shape[0]
    C = dims["C"]
    n_cols = dims["n_cols"]
    h, w = cam.height, cam.width
    dev = pts.pos.device
    dtype = pts.pos.dtype

    # ---- project all landmarks -------------------------------------------
    xyz_cur = T_cw.apply(pts.pos)
    in_front = xyz_cur[..., 2] > 1e-3
    z_safe = torch.where(in_front, xyz_cur[..., 2],
                         torch.ones_like(xyz_cur[..., 2]))
    px = cam.world2cam(torch.cat([xyz_cur[..., :2], z_safe[..., None]], -1))
    margin = cfg.patch_halfsize + 2
    cam_pos_w = T_cw.inverse().t

    src_kf, src_px, src_level, src_f, angle_ok = closest_view_obs(
        pts, vo.kfs, cam_pos_w, cfg)

    # working set: points whose patch source is among the closest
    # overlapping keyframes
    kf_pos = _kf_cam_pos(vo.kfs, slice(None))
    kf_dist = torch.linalg.norm(kf_pos - cam_pos_w, dim=-1)
    kf_usable = vo.kfs.valid
    if cfg.kf_select_covisibility:
        overlap = keyframe_overlap(vo, T_cw, cam, cfg)
        kf_usable = kf_usable & (overlap >= cfg.kf_overlap_min_fts)
    kf_dist = torch.where(kf_usable, kf_dist,
                          torch.full_like(kf_dist, float("inf")))
    K = kf_dist.shape[0]
    n_close = min(cfg.max_n_kfs_reproject, K)
    close_thresh = torch.sort(kf_dist).values[n_close - 1]
    kf_close = kf_usable & (kf_dist <= close_thresh)
    src_c = torch.clamp(src_kf, 0, K - 1).to(torch.int64)
    visible = (pts.valid & in_front & interp.in_bounds(px, h, w, margin)
               & vo.kfs.valid[src_c] & kf_close[src_c])

    # ---- warped-patch cache refresh (budget, oldest visible first) ---------
    never = visible & (pts.warp_frame < 0)
    age = torch.where(never, torch.full_like(pts.warp_frame, _I32_MIN + 1),
                      pts.warp_frame)
    age = torch.where(visible, age, torch.full_like(age, _I32_MAX))
    Bw = min(cfg.warp_refresh_budget, P)
    ridx = torch.argsort(age, stable=True)[:Bw]
    rok = visible[ridx]
    r_kf = src_c[ridx]
    depth_r = torch.linalg.norm(pts.pos[ridx] - _kf_cam_pos(vo.kfs, r_kf),
                                dim=-1)
    T_cr = _relative_pose(T_cw, vo.kfs, r_kf)
    patch_r, slv_r, grad_r, ok_r = matcher.compute_warp_batch(
        vo.kfs.stack, r_kf, cam, src_px[ridx], src_f[ridx], depth_r,
        src_level[ridx], T_cr, rok, cfg, ref_grad=pts.ref_grad[ridx])
    rscat = torch.where(ok_r, ridx, torch.full_like(ridx, P))
    pts = pts.replace(
        warp_patch=set_rows(pts.warp_patch, rscat, patch_r),
        warp_level=set_rows(pts.warp_level, rscat, slv_r),
        warp_grad=set_rows(pts.warp_grad, rscat, grad_r),
        warp_frame=set_rows(pts.warp_frame, rscat, vo.frame_id))

    # ---- quality-ordered candidate chain per cell ---------------------------
    cid = cell_index(px, w, cfg.grid_size, n_cols)
    cid = torch.clamp(cid, 0, C - 1).to(torch.int64)
    slot_ids = torch.arange(P, dtype=torch.int64, device=dev)
    cached = pts.warp_frame >= 0
    key0 = torch.where(
        visible, (cached.to(torch.int64) * 4 + pts.ptype.to(torch.int64)) * P
        + slot_ids, torch.full_like(slot_ids, -1))

    tried = torch.zeros((P,), dtype=torch.bool, device=dev)
    need = torch.ones((C,), dtype=torch.bool, device=dev)
    succ_add = torch.zeros((P,), dtype=torch.int32, device=dev)
    fail_add = torch.zeros((P,), dtype=torch.int32, device=dev)
    feats = {
        "px": torch.zeros((C, 2), dtype=dtype, device=dev),
        "f": torch.zeros((C, 3), dtype=dtype, device=dev),
        "level": torch.zeros((C,), dtype=torch.int32, device=dev),
        "point": torch.full((C,), -1, dtype=torch.int32, device=dev),
        "valid": torch.zeros((C,), dtype=torch.bool, device=dev),
    }
    for round_i in range(1 + cfg.reproject_n_retries):
        key = torch.where(tried, torch.full_like(key0, -1), key0)
        cell_best = torch.full((C,), -1, dtype=torch.int64, device=dev)
        cell_best = cell_best.scatter_reduce(0, cid, key, "amax",
                                             include_self=True)
        winner = torch.where(cell_best >= 0, cell_best % P,
                             torch.zeros_like(cell_best))
        cell_has = (cell_best >= 0) & need
        if round_i == 0:
            cells = torch.arange(C, dtype=torch.int64, device=dev)
            cand = winner
            cand_ok = cell_has
        else:
            B = min(cfg.reproject_retry_budget, C)
            cells = compact(cell_has, B)
            cand_ok = cells >= 0
            cells = torch.clamp(cells, min=0)
            cand = winner[cells]

        tried = set_rows(tried, torch.where(cand_ok, cand,
                                            torch.full_like(cand, P)), True)

        px_init = px[cand]
        has_cache = cached[cand]
        attempted = cand_ok & has_cache
        try_ok = attempted & angle_ok[cand]
        px_cur, success = matcher.match_cached(
            cur_stack, cam, pts.warp_patch[cand], pts.warp_level[cand],
            px_init, try_ok, cfg, warp_grad=pts.warp_grad[cand],
            ref_type=pts.ref_type[cand])
        search_level = torch.clamp(pts.warp_level[cand], 0,
                                   cfg.max_search_level)

        pslot = torch.where(attempted, cand, torch.full_like(cand, P))
        succ_add = add_rows(succ_add, pslot, success.to(torch.int32))
        fail_add = add_rows(fail_add, pslot,
                            (attempted & ~success).to(torch.int32))

        f_cur = cam.cam2world(px_cur)
        cslot = torch.where(success, cells, torch.full_like(cells, C))
        feats = {
            "px": set_rows(feats["px"], cslot, px_cur),
            "f": set_rows(feats["f"], cslot, f_cur),
            "level": set_rows(feats["level"], cslot, search_level),
            "point": set_rows(feats["point"], cslot, cand),
            "valid": set_rows(feats["valid"], cslot, True),
        }
        need = set_rows(need, cslot, False)
    if cfg.max_fts < C:
        rank = torch.cumsum(feats["valid"].to(torch.int32), 0)
        keep = feats["valid"] & (rank <= cfg.max_fts)
        feats["valid"] = keep
        feats["point"] = torch.where(keep, feats["point"],
                                     torch.full_like(feats["point"], -1))
    n_succ = pts.n_succ + succ_add
    n_fail = pts.n_fail + fail_add
    ptype = pts.ptype
    ptype = torch.where((ptype == st.TYPE_UNKNOWN)
                        & (n_succ >= cfg.point_min_succ_good),
                        torch.full_like(ptype, st.TYPE_GOOD), ptype)
    del_unk = (((ptype == st.TYPE_UNKNOWN) | (ptype == st.TYPE_CANDIDATE))
               & (n_fail > cfg.point_max_reproj_fail_unknown))
    del_good = ((ptype == st.TYPE_GOOD)
                & (n_fail > cfg.point_max_reproj_fail_good))
    ptype = torch.where(del_unk | del_good,
                        torch.full_like(ptype, st.TYPE_DELETED), ptype)
    points_new = pts.replace(n_succ=n_succ, n_fail=n_fail, ptype=ptype)
    n_matches = torch.sum(feats["valid"]).to(torch.int32)
    return feats, points_new, n_matches


def _kf_cam_pos(kfs: st.KeyframeArena, slots) -> torch.Tensor:
    """World position of keyframe cameras (-R^T t); `slots` indexes the
    arena (a tensor of slots, or a slice)."""
    return SE3(q=kfs.q_kw[slots], t=kfs.t_kw[slots]).inverse().t


def _relative_pose(T_cw: SE3, kfs: st.KeyframeArena, slots) -> SE3:
    """T_cur_ref = T_cw o (T_kw)^-1, composed once per keyframe, gathered
    per slot."""
    T_k = T_cw.compose(SE3(q=kfs.q_kw, t=kfs.t_kw).inverse())
    return SE3(q=T_k.q[slots], t=T_k.t[slots])
