"""The per-frame VO pipeline: pyramid -> sparse align -> map reprojection ->
pose GN -> structure GN -> seed updates -> keyframe policy — port of
`android_svo_tpu/core/pipeline.py`.

Runs eagerly: keyframe insertion is a Python `if` on one scalar read
(`profiling.host_read`, site `keyframe`), and the state is updated
functionally (every write builds a new tensor), so the keyframe arena and
the last frame never alias.  Each stage is a span named after the
reference's timers (`utils/profiling.py`: `pyramid_creation`,
`sparse_img_align`, `reproject`, `pose_optimizer`, `point_optimizer`,
`depth_filter`, `keyframe`), recorded with its host times while a monitor
is installed and a profiler range while `torch.profiler` runs; with
neither, a span costs one check.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as _pytree

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import depth_filter as df
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.core.point_opt import optimize_structure
from android_svo_tpu_torch.core.pose_opt import optimize_pose
from android_svo_tpu_torch.core.reprojector import (_kf_cam_pos,
                                                    _relative_pose,
                                                    keyframe_overlap,
                                                    reproject_map)
from android_svo_tpu_torch.core.scatter import (add_rows, compact,
                                                gather_rows, put_row,
                                                set_rows, take_row)
from android_svo_tpu_torch.geometry.camera import for_config
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.geometry.triangulation import masked_median
from android_svo_tpu_torch.ops import detect, interp, matcher
from android_svo_tpu_torch.ops.pyramid import build_pyramid, stack_from_pyramid
from android_svo_tpu_torch.ops.sparse_align import sparse_img_align
from android_svo_tpu_torch.utils import profiling

RES_FAILURE = 0
RES_NO_KEYFRAME = 1
RES_IS_KEYFRAME = 2

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min


# ---------------------------------------------------------------------------
# depth-filter frame update
# ---------------------------------------------------------------------------

def update_seeds(vo: st.VOState, cur_stack, T_cw: SE3, cam,
                 cfg: SVOConfig) -> st.VOState:
    """One batched Bayesian update of every live seed against the current
    frame: visibility gate -> epipolar ZMSSD match -> tau -> posterior."""
    seeds = vo.seeds
    dtype = seeds.mu.dtype
    S = seeds.valid.shape[0]
    skf = seeds.kf.to(torch.int64)

    T_cur_ref = _relative_pose(T_cw, vo.kfs, skf)

    too_old = (vo.kf_batch - seeds.batch_id) > cfg.seed_max_kf_age
    alive = seeds.valid & ~too_old & vo.kfs.valid[skf]

    z_mean = 1.0 / torch.clamp(seeds.mu, min=1e-6)
    xyz_cur = T_cur_ref.apply(seeds.f * z_mean[:, None])
    in_front = xyz_cur[..., 2] > 1e-3
    zs = torch.where(in_front, xyz_cur[..., 2], torch.ones_like(z_mean))
    px_mean = cam.world2cam(torch.cat([xyz_cur[..., :2], zs[..., None]], -1))
    visible = alive & in_front & interp.in_bounds(
        px_mean, cam.height, cam.width, cfg.patch_halfsize + 2)

    sig = torch.sqrt(seeds.sigma2)
    d_min = 1.0 / torch.clamp(seeds.mu + sig, min=1e-7)
    d_max = 1.0 / torch.clamp(seeds.mu - sig, min=1e-7)
    d_max = torch.clamp(d_max, max=1e4)

    # seed-patch cache refresh (budget, stalest visible first)
    never_s = visible & (seeds.patch_frame < 0)
    age_s = torch.where(never_s, torch.full_like(seeds.patch_frame,
                                                 _I32_MIN + 1),
                        seeds.patch_frame)
    age_s = torch.where(visible, age_s, torch.full_like(age_s, _I32_MAX))
    Bs = min(cfg.seed_warp_refresh_budget, S)
    ridx = torch.argsort(age_s, stable=True)[:Bs]
    rok = visible[ridx]
    patch_r, slv_r, _, ok_r = matcher.compute_warp_batch(
        vo.kfs.stack, seeds.kf[ridx], cam, seeds.px[ridx], seeds.f[ridx],
        z_mean[ridx], seeds.level[ridx],
        SE3(q=T_cur_ref.q[ridx], t=T_cur_ref.t[ridx]), rok, cfg)
    rscat = torch.where(ok_r, ridx, torch.full_like(ridx, S))
    seeds = seeds.replace(
        patch=set_rows(seeds.patch, rscat, patch_r),
        patch_level=set_rows(seeds.patch_level, rscat, slv_r),
        patch_frame=set_rows(seeds.patch_frame, rscat, vo.frame_id))

    # compact the visible seeds into a fixed budget; a frame-rotating offset
    # round-robins which ones update when more are visible than the budget
    budget = min(cfg.seed_update_budget, S)
    offset = (vo.frame_id.to(torch.int64) * 257) % S
    ar = torch.arange(S, device=visible.device)
    rot_vis = visible[(ar + offset) % S]
    idx = compact(rot_vis, budget)
    sel = idx >= 0
    idx = (torch.clamp(idx, min=0) + offset) % S
    sel = sel & (seeds.patch_frame[idx] >= 0)

    z_b, _, found_b = matcher.find_epipolar_match(
        cur_stack, vo.kfs.stack, seeds.kf[idx], cam, seeds.px[idx],
        seeds.f[idx], seeds.level[idx],
        SE3(q=T_cur_ref.q[idx], t=T_cur_ref.t[idx]),
        z_mean[idx], d_min[idx], d_max[idx], sel, cfg,
        cached=(seeds.patch[idx], seeds.patch_level[idx]))

    scat = torch.where(sel, idx, torch.full_like(idx, S))
    z = set_rows(torch.ones((S,), dtype=dtype, device=z_b.device), scat, z_b)
    found = set_rows(torch.zeros((S,), dtype=torch.bool, device=z_b.device),
                     scat, found_b)
    attempted = set_rows(torch.zeros((S,), dtype=torch.bool,
                                     device=z_b.device), scat, True)

    ang = df.px_error_angle(cam.fx, cfg.d_filter_px_noise)
    T_ref_cur = T_cur_ref.inverse()
    tau = df.compute_tau(T_ref_cur.t, seeds.f, z, ang)
    tau_inv = df.tau_inverse(z, tau)
    a2, b2, mu2, s22 = df.update_seed(
        1.0 / torch.clamp(z, min=1e-7), tau_inv * tau_inv,
        seeds.a, seeds.b, seeds.mu, seeds.sigma2, seeds.z_range)
    upd = found
    seeds2 = seeds.replace(
        a=torch.where(upd, a2, seeds.a), b=torch.where(upd, b2, seeds.b),
        mu=torch.where(upd, mu2, seeds.mu),
        sigma2=torch.where(upd, s22, seeds.sigma2), valid=alive)
    failed = attempted & ~found
    seeds2 = seeds2.replace(b=torch.where(failed, seeds2.b + 1.0, seeds2.b))

    conv = seeds2.valid & df.is_converged(seeds2.sigma2, seeds2.z_range, cfg)
    return promote_converged_seeds(vo.replace(seeds=seeds2), conv, cam, cfg)


def promote_converged_seeds(vo: st.VOState, conv, cam, cfg: SVOConfig,
                            max_new: int = 256) -> st.VOState:
    """Move converged seeds into the landmark arena as TYPE_CANDIDATE, up to
    `max_new` per frame (fixed-size compaction)."""
    pts = vo.points
    seeds = vo.seeds
    P = pts.pos.shape[0]

    conv_idx = compact(conv, max_new)
    free_idx = compact(pts.ptype == st.TYPE_DELETED, max_new)
    take = (conv_idx >= 0) & (free_idx >= 0)
    src = torch.where(take, conv_idx, torch.zeros_like(conv_idx))
    dst = torch.where(take, free_idx, torch.full_like(free_idx, P))

    skf = seeds.kf[src].to(torch.int64)
    T_kw = SE3(q=vo.kfs.q_kw[skf], t=vo.kfs.t_kw[skf])
    z = 1.0 / torch.clamp(seeds.mu[src], min=1e-7)
    pos_w = T_kw.inverse().apply(seeds.f[src] * z[:, None])

    pts2 = pts.replace(
        pos=set_rows(pts.pos, dst, pos_w),
        ptype=set_rows(pts.ptype, dst, torch.where(
            take, st.TYPE_CANDIDATE, 0).to(torch.int32)),
        n_succ=set_rows(pts.n_succ, dst, 0),
        n_fail=set_rows(pts.n_fail, dst, 0),
        last_optim=set_rows(pts.last_optim, dst, 0),
        ref_kf=set_rows(pts.ref_kf, dst, seeds.kf[src]),
        ref_px=set_rows(pts.ref_px, dst, seeds.px[src]),
        ref_level=set_rows(pts.ref_level, dst, seeds.level[src]),
        ref_f=set_rows(pts.ref_f, dst, seeds.f[src]),
        ref_type=set_rows(pts.ref_type, dst, seeds.ftype[src]),
        ref_grad=set_rows(pts.ref_grad, dst, seeds.grad[src]),
        obs_kf=set_rows(pts.obs_kf, dst, -1),
        obs_count=set_rows(pts.obs_count, dst, 0),
        warp_patch=set_rows(pts.warp_patch, dst, seeds.patch[src]),
        warp_level=set_rows(pts.warp_level, dst, seeds.patch_level[src]),
        warp_frame=set_rows(pts.warp_frame, dst, seeds.patch_frame[src]),
        warp_grad=set_rows(pts.warp_grad, dst, seeds.grad[src]),
    )
    # retire the promoted seeds (rows that did not take write nothing)
    promoted = set_rows(torch.zeros_like(conv),
                        torch.where(take, src, torch.full_like(src, -1)),
                        True)
    seeds2 = seeds.replace(valid=seeds.valid & ~(conv & promoted))
    return vo.replace(points=pts2, seeds=seeds2)


# ---------------------------------------------------------------------------
# keyframe insertion
# ---------------------------------------------------------------------------

def select_kf_slot(vo: st.VOState, T_cw: SE3) -> torch.Tensor:
    """First free slot, else the keyframe furthest from the camera."""
    kfs = vo.kfs
    any_free = torch.any(~kfs.valid)
    first_free = torch.argmin(kfs.valid.to(torch.int32))
    cam_pos = T_cw.inverse().t
    dist = torch.linalg.norm(_kf_cam_pos(kfs, slice(None)) - cam_pos, dim=-1)
    dist = torch.where(kfs.valid, dist, torch.full_like(dist, -1.0))
    furthest = torch.argmax(dist)
    return torch.where(any_free, first_free, furthest).to(torch.int64)


def _set_slot(table: torch.Tensor, slot: torch.Tensor, row, commit=None):
    """table.at[slot].set(row) for a (K, ...) arena and a 0-d slot; with a
    0-d bool `commit`, the slot's old row is written back where it is false
    (one row moves, not the arena).  The slot is never read back to the
    host."""
    if commit is not None:
        row = torch.where(commit, torch.as_tensor(row, dtype=table.dtype,
                                                device=table.device),
                          take_row(table, slot))
    return put_row(table, slot, row)


def insert_keyframe(vo: st.VOState, cur_pyr, cur_stack, T_cw: SE3, feats,
                    cam, cfg: SVOConfig, dims, commit=None) -> st.VOState:
    """Write the current frame into the keyframe arena: adopt candidate
    points, record observations, detect new corners, spawn seeds.

    `commit` (a 0-d bool, for the batched step under vmap) keeps the state
    as it was where it is false: the keyframe arena's rows are written
    back, the other arenas selected."""
    dtype = cur_stack.dtype
    dev = cur_stack.device
    C = dims["C"]
    K = vo.kfs.valid.shape[0]
    slot = select_kf_slot(vo, T_cw)
    evicting = take_row(vo.kfs.valid, slot)

    # ---- scrub state tied to an evicted keyframe ---------------------------
    seeds = vo.seeds
    seeds = seeds.replace(valid=(seeds.valid & (seeds.kf != slot))
                          | (~evicting & seeds.valid))
    pts = vo.points
    evict_obs = (pts.obs_kf == slot) & evicting
    obs_kf = torch.where(evict_obs, torch.full_like(pts.obs_kf, -1),
                         pts.obs_kf)
    obs_alive = (obs_kf >= 0) & vo.kfs.valid[
        torch.clamp(obs_kf, 0, K - 1).to(torch.int64)]
    alt = torch.argmax(obs_alive.to(torch.int32), dim=-1)    # first alive
    has_alt = torch.any(obs_alive, dim=-1)
    need = (pts.ref_kf == slot) & evicting & pts.valid
    na = need & has_alt

    def take(a):
        idx = alt.reshape((alt.shape[0], 1) + (1,) * (a.dim() - 2))
        idx = idx.expand((alt.shape[0], 1) + tuple(a.shape[2:]))
        return torch.gather(a, 1, idx)[:, 0]

    pts = pts.replace(
        obs_kf=obs_kf,
        ptype=torch.where(need & ~has_alt,
                          torch.full_like(pts.ptype, st.TYPE_DELETED),
                          pts.ptype),
        ref_kf=torch.where(na, take(obs_kf), pts.ref_kf),
        ref_px=torch.where(na[:, None], take(pts.obs_px), pts.ref_px),
        ref_level=torch.where(na, take(pts.obs_level), pts.ref_level),
        ref_f=torch.where(na[:, None], take(pts.obs_f), pts.ref_f),
        ref_type=torch.where(na, torch.full_like(pts.ref_type,
                                                 detect.FTYPE_CORNER),
                             pts.ref_type))

    # ---- scene depth of the current frame ----------------------------------
    p_w = gather_rows(pts.pos, feats["point"])
    xyz_cur = T_cw.apply(p_w)
    ok = feats["valid"] & (feats["point"] >= 0)
    depth_med = masked_median(xyz_cur[..., 2], ok)
    depth_min = torch.amin(torch.where(ok, xyz_cur[..., 2],
                                       torch.full_like(xyz_cur[..., 2],
                                                       float("inf"))))
    depth_med = torch.where(torch.isfinite(depth_med), depth_med,
                            torch.ones_like(depth_med))
    depth_min = torch.where(torch.isfinite(depth_min), depth_min,
                            torch.full_like(depth_min, 0.5))

    # ---- candidate adoption + observation records (ok rows only; the
    # rows that are not ok write nothing, so every write is unique) ---------
    P = pts.pos.shape[0]
    pid = torch.where(ok, feats["point"].to(torch.int64),
                      torch.full_like(feats["point"], P, dtype=torch.int64))
    pid_c = torch.clamp(pid, max=P - 1)
    adopted = ok & (pts.ptype[pid_c] == st.TYPE_CANDIDATE)
    pts = pts.replace(ptype=set_rows(
        pts.ptype, torch.where(adopted, pid, torch.full_like(pid, P)),
        st.TYPE_UNKNOWN))
    O = pts.obs_kf.shape[1]
    o_idx = torch.clamp(pts.obs_count[pid_c], max=O - 1).to(torch.int64)
    flat = torch.where(ok, pid_c * O + o_idx, torch.full_like(pid, P * O))

    def set_obs(table, val):
        shp = table.shape
        out = set_rows(table.reshape((P * O,) + shp[2:]), flat, val)
        return out.reshape(shp)

    pts = pts.replace(
        obs_kf=set_obs(pts.obs_kf, slot.to(torch.int32)),
        obs_f=set_obs(pts.obs_f, feats["f"]),
        obs_px=set_obs(pts.obs_px, feats["px"]),
        obs_level=set_obs(pts.obs_level, feats["level"]),
        obs_count=add_rows(pts.obs_count, pid, 1))

    # ---- write the keyframe -------------------------------------------------
    kfs = vo.kfs
    kfs = kfs.replace(
        stack=_set_slot(kfs.stack, slot, cur_stack, commit),
        q_kw=_set_slot(kfs.q_kw, slot, T_cw.q, commit),
        t_kw=_set_slot(kfs.t_kw, slot, T_cw.t, commit),
        valid=_set_slot(kfs.valid, slot, True, commit),
        frame_id=_set_slot(kfs.frame_id, slot, vo.frame_id, commit),
        scene_depth=_set_slot(kfs.scene_depth, slot, depth_med, commit),
        ftr_px=_set_slot(kfs.ftr_px, slot, feats["px"], commit),
        ftr_f=_set_slot(kfs.ftr_f, slot, feats["f"], commit),
        ftr_level=_set_slot(kfs.ftr_level, slot, feats["level"], commit),
        ftr_point=_set_slot(
            kfs.ftr_point, slot,
            torch.where(feats["valid"], feats["point"],
                        torch.full_like(feats["point"], -1)), commit),
        ftr_valid=_set_slot(kfs.ftr_valid, slot, feats["valid"], commit),
    )

    # ---- detect new corners in unoccupied cells, spawn seeds ----------------
    det = detect.detect_features(cur_pyr[:cfg.n_pyr_levels], feats["valid"],
                                 cfg)
    new_mask = det["valid"]
    f_new = cam.cam2world(det["px"])
    a0, b0, mu0, s20, zr0 = df.seed_init(
        torch.ones((C,), dtype=dtype, device=dev) * depth_med,
        torch.ones((C,), dtype=dtype, device=dev) * (0.5 * depth_min))

    S = seeds.valid.shape[0]
    new_idx = compact(new_mask, C)
    free_idx = compact(~seeds.valid, C)
    take_s = (new_idx >= 0) & (free_idx >= 0)
    src = torch.where(take_s, new_idx, torch.zeros_like(new_idx))
    dst = torch.where(take_s, free_idx, torch.full_like(free_idx, S))
    batch = vo.kf_batch + 1
    seeds = seeds.replace(
        kf=set_rows(seeds.kf, dst, slot.to(torch.int32)),
        px=set_rows(seeds.px, dst, det["px"][src]),
        f=set_rows(seeds.f, dst, f_new[src]),
        level=set_rows(seeds.level, dst, det["level"][src]),
        ftype=set_rows(seeds.ftype, dst, det["ftype"][src]),
        grad=set_rows(seeds.grad, dst, det["grad"][src]),
        a=set_rows(seeds.a, dst, a0[src]),
        b=set_rows(seeds.b, dst, b0[src]),
        mu=set_rows(seeds.mu, dst, mu0[src]),
        sigma2=set_rows(seeds.sigma2, dst, s20[src]),
        z_range=set_rows(seeds.z_range, dst, zr0[src]),
        batch_id=set_rows(seeds.batch_id, dst, batch),
        valid=set_rows(seeds.valid, dst, take_s),
    )

    # spawn-time patch-cache fill: the identity warp from the new keyframe
    patch_new, slv_new, _ = matcher.identity_warp_patches(
        kfs.stack, slot.expand(C), det["px"], det["level"], new_mask, cfg,
        cam.height, cam.width)
    seeds = seeds.replace(
        patch=set_rows(seeds.patch, dst, patch_new[src]),
        patch_level=set_rows(seeds.patch_level, dst, slv_new[src]),
        patch_frame=set_rows(seeds.patch_frame, dst, vo.frame_id))

    if commit is not None:
        def keep(new, old):
            return torch.where(commit, new, old)
        pts = _pytree.tree_map(keep, pts, vo.points)
        seeds = _pytree.tree_map(keep, seeds, vo.seeds)
        batch = keep(batch, vo.kf_batch)
    return vo.replace(kfs=kfs, points=pts, seeds=seeds, kf_batch=batch)


def need_new_keyframe(vo: st.VOState, T_cw: SE3, scene_depth, cam,
                      cfg: SVOConfig) -> torch.Tensor:
    """New keyframe iff no (covisible) keyframe lies within
    `kfselect_mindist` x scene depth of the camera."""
    cam_pos = T_cw.inverse().t
    kf_pos = _kf_cam_pos(vo.kfs, slice(None))
    rel = torch.linalg.norm(kf_pos - cam_pos, dim=-1) / torch.clamp(
        scene_depth, min=1e-6)
    usable = vo.kfs.valid
    if cfg.kf_select_covisibility:
        overlap = keyframe_overlap(vo, T_cw, cam, cfg)
        usable = usable & (overlap >= cfg.kf_overlap_min_fts)
    rel = torch.where(usable, rel, torch.full_like(rel, float("inf")))
    return torch.all(rel > cfg.kfselect_mindist)


# ---------------------------------------------------------------------------
# the tracking step
# ---------------------------------------------------------------------------

def frame_pyramid(img: torch.Tensor, cfg: SVOConfig):
    """The frame's pyramid (a tuple of levels) and its padded stack."""
    with profiling.span("pyramid_creation"):
        cur_pyr = build_pyramid(img, cfg.total_pyr_levels)
        return cur_pyr, stack_from_pyramid(cur_pyr)


def align_inputs(vo: st.VOState):
    """Sparse alignment's reference: the last frame's features with their
    depths and which of them carry a live landmark."""
    last = vo.last
    p_w = gather_rows(vo.points.pos, last.ftr_point)
    last_cam_pos = last.T_fw.inverse().t
    depth_last = torch.linalg.norm(p_w - last_cam_pos, dim=-1)
    has_pt = (last.ftr_valid & (last.ftr_point >= 0)
              & gather_rows(vo.points.valid, last.ftr_point))
    return depth_last, has_pt


def track_map(vo: st.VOState, cur_stack, T_cur_last: SE3, cam,
              cfg: SVOConfig, dims):
    """STEPS 2-5 and the keyframe decision: map reprojection, pose and
    structure optimisation, the quality gate, the depth-filter update.
    Returns (vo, feats, T_final, cov, failure, make_kf, n_matches,
    n_edges)."""
    T_cw = T_cur_last.compose(vo.last.T_fw)

    # STEP 2: map reprojection + feature alignment
    with profiling.span("reproject"):
        feats, points2, n_matches = reproject_map(vo, cur_stack, T_cw,
                                                  cam, cfg, dims)
        vo = vo.replace(points=points2)

    # STEP 3: pose optimization
    with profiling.span("pose_optimizer"):
        p_w = gather_rows(vo.points.pos, feats["point"])
        T_cw_opt, inlier, n_edges, cov, _, _ = optimize_pose(
            T_cw, p_w, feats["f"], feats["level"], feats["valid"],
            cam.errorMultiplier2(), cfg)
        feats["valid"] = feats["valid"] & inlier
        feats["point"] = torch.where(feats["valid"], feats["point"],
                                     torch.full_like(feats["point"], -1))

    # STEP 4: structure optimization
    with profiling.span("point_optimizer"):
        vo = vo.replace(points=optimize_structure(vo.points, vo.kfs,
                                                  vo.frame_id, cfg))

    # quality gate
    n_last = torch.sum(vo.last.ftr_valid).to(torch.int32)
    tracking_bad = (n_edges < cfg.quality_min_fts) | (
        (n_last - n_edges) > cfg.quality_max_drop_fts)
    failure = tracking_bad | (n_matches < cfg.min_reproj_matches)
    T_final = SE3(q=torch.where(failure, vo.last.q_fw, T_cw_opt.q),
                  t=torch.where(failure, vo.last.t_fw, T_cw_opt.t))

    # STEP 5: depth-filter update
    with profiling.span("depth_filter"):
        vo = update_seeds(vo, cur_stack, T_final, cam, cfg)

    # STEP 6 (decision): a keyframe where no keyframe is close
    with profiling.span("keyframe"):
        xyz_cur = T_final.apply(gather_rows(vo.points.pos, feats["point"]))
        scene_depth = masked_median(xyz_cur[..., 2], feats["valid"])
        scene_depth = torch.where(torch.isfinite(scene_depth), scene_depth,
                                  torch.ones_like(scene_depth))
        make_kf = (~failure) & need_new_keyframe(vo, T_final, scene_depth,
                                                 cam, cfg)
    return vo, feats, T_final, cov, failure, make_kf, n_matches, n_edges


def finish_frame(vo: st.VOState, cur_stack, T_final: SE3, feats, cov,
                 failure, make_kf, n_tracked, n_matches, n_edges):
    """The frame becomes the last frame; the step's outputs."""
    last_new = st.FrameState(
        stack=cur_stack, q_fw=T_final.q, t_fw=T_final.t,
        ftr_px=feats["px"], ftr_f=feats["f"], ftr_level=feats["level"],
        ftr_point=feats["point"], ftr_valid=feats["valid"])
    vo = vo.replace(last=last_new, frame_id=vo.frame_id + 1, pose_cov=cov)
    result = torch.where(failure, RES_FAILURE,
                         torch.where(make_kf, RES_IS_KEYFRAME,
                                     RES_NO_KEYFRAME))
    out = {
        "T_cw": T_final,
        "t_wc": T_final.inverse().t,
        "result": result,
        "n_tracked": n_tracked,
        "n_matches": n_matches,
        "n_edges": n_edges,
        "n_seeds": torch.sum(vo.seeds.valid).to(torch.int32),
        "n_points": torch.sum(vo.points.valid).to(torch.int32),
    }
    return vo, out


def make_track_frame(cfg: SVOConfig, cam, dims):
    """Build `track_frame(vo, img) -> (vo, out)`; the step runs on the
    device the state and image live on.  Its stages (`frame_pyramid`,
    `align_inputs`, `sparse_img_align`, `track_map`, `insert_keyframe`,
    `finish_frame`) are the batched step's too
    (`parallel/multi_seq.py`).  The step holds `cam` as `cfg.use_pallas`
    has it (`geometry.camera.for_config`)."""
    cam = for_config(cam, cfg)

    def track_frame(vo: st.VOState, img: torch.Tensor):
        cur_pyr, cur_stack = frame_pyramid(img, cfg)

        # STEP 1: sparse image alignment against the last frame
        with profiling.span("sparse_img_align"):
            depth_last, has_pt = align_inputs(vo)
            last = vo.last
            T_cur_last, n_tracked, _ = sparse_img_align(
                last.stack, cur_stack, cam,
                SE3.identity(dtype=img.dtype, device=img.device),
                last.ftr_px, last.ftr_f, depth_last, has_pt, cfg)

        vo, feats, T_final, cov, failure, make_kf, n_matches, n_edges = \
            track_map(vo, cur_stack, T_cur_last, cam, cfg, dims)

        # STEP 6: keyframe insertion (the stage's one host read)
        with profiling.span("keyframe"):
            if profiling.host_read(make_kf, "keyframe"):
                vo = insert_keyframe(vo, cur_pyr, cur_stack, T_final, feats,
                                     cam, cfg, dims)
        return finish_frame(vo, cur_stack, T_final, feats, cov, failure,
                            make_kf, n_tracked, n_matches, n_edges)

    return track_frame


def make_track_scan(cfg: SVOConfig, cam, dims):
    """Build `track_scan(vo, imgs) -> (vo, outs)`: `track_frame` over a
    stacked (N, H, W) batch (or any sequence of frames), with the per-frame
    `t_wc`, `result`, `n_matches` and `n_edges` stacked along a leading
    axis.  The loop reads nothing back to the host between frames (the
    step's own keyframe decision is its one read).  It covers the DEFAULT
    steady state, keyframe insertion included; the stage machine keeps
    bootstrap and relocalization, and local BA is dispatched between
    scans."""
    track = make_track_frame(cfg, cam, dims)
    keys = ("t_wc", "result", "n_matches", "n_edges")

    def track_scan(vo: st.VOState, imgs):
        outs = {k: [] for k in keys}
        for img in imgs:
            vo, out = track(vo, img)
            for k in keys:
                outs[k].append(out[k])
        return vo, {k: torch.stack(v) for k, v in outs.items()}

    return track_scan
