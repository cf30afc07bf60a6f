"""Frame handler: the host-side stage machine FIRST -> SECOND -> DEFAULT,
with RELOCALIZING on tracking failure, and local bundle adjustment after
every `loba_every_n_kfs`-th keyframe — port of
`android_svo_tpu/core/frame_handler.py`.

Each `add_image` is one unit span `tot_time` (`utils/profiling.py`); the
first and second frame, with the map built from them, span `bootstrap`;
a tracked frame's call spans `fused_track_dispatch` and its six result
reads are `host_read`s (site `result`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import pipeline, state as st
from android_svo_tpu_torch.core.initialization import (bootstrap_pair,
                                                       ransac_draws)
from android_svo_tpu_torch.core.reprojector import _kf_cam_pos
from android_svo_tpu_torch.core.scatter import compact, set_rows, take_row
from android_svo_tpu_torch.geometry.camera import for_config
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import detect, matcher
from android_svo_tpu_torch.ops.detect import cell_index
from android_svo_tpu_torch.ops.pyramid import build_pyramid, stack_from_pyramid
from android_svo_tpu_torch.parallel.ba import local_ba, select_core_keyframes
from android_svo_tpu_torch.utils import profiling

STAGE_PAUSED = 0
STAGE_FIRST_FRAME = 1
STAGE_SECOND_FRAME = 2
STAGE_DEFAULT_FRAME = 3
STAGE_RELOCALIZING = 4


@dataclass
class TrackResult:
    T_cw: SE3
    stage: int
    result: int
    n_matches: int = 0
    n_edges: int = 0
    n_seeds: int = 0
    n_points: int = 0
    t_wc: object = None


def _scatter_to_cells(px, f, level, point, valid, cfg, dims, w):
    """Scatter features into the per-cell table layout (one feature per
    cell; on a collision the highest row index wins, as the JAX scatter's
    last write does)."""
    C = dims["C"]
    n = px.shape[0]
    dev = px.device
    cid = torch.clamp(cell_index(px, w, cfg.grid_size, dims["n_cols"]), 0,
                      C - 1).to(torch.int64)
    cid = torch.where(valid, cid, torch.full_like(cid, C))
    rows = torch.arange(n, device=dev)
    winner = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, cid, rows, "amax", include_self=True)
    winner = winner[:C]
    has = winner >= 0
    src = torch.clamp(winner, min=0)

    def pick(vals, empty):
        picked = vals[src]
        mask = has.reshape((C,) + (1,) * (vals.dim() - 1))
        return torch.where(mask, picked, empty)

    zero = torch.zeros((), dtype=px.dtype, device=dev)
    return {"px": pick(px, zero), "f": pick(f, zero),
            "level": pick(level.to(torch.int32),
                          torch.zeros((), dtype=torch.int32, device=dev)),
            "point": pick(point.to(torch.int32),
                          torch.full((), -1, dtype=torch.int32, device=dev)),
            "valid": pick(valid, torch.zeros((), dtype=torch.bool,
                                             device=dev))}


def init_map_from_bootstrap(vo: st.VOState, boot, ref_pyr, cur_pyr,
                            T_ref_w: SE3, det_level, cam, cfg: SVOConfig,
                            dims) -> st.VOState:
    """Populate the arenas from a successful two-frame bootstrap:
    landmarks, keyframe 0 (first frame), keyframe 1 (second frame, through
    the standard insertion path) and the last frame."""
    C = dims["C"]
    dev = boot["xyz_ref"].device
    good = boot["inlier"]
    slots = torch.arange(C, dtype=torch.int64, device=dev)
    ref_stack = stack_from_pyramid(ref_pyr)
    cur_stack = stack_from_pyramid(cur_pyr)
    px_ref = boot["px_ref"]
    det_level = det_level.to(torch.int32)
    i32 = torch.int32

    pos_w = T_ref_w.inverse().apply(boot["xyz_ref"])
    pts = vo.points

    def obs0(table, val):
        out = table.clone()
        out[:C, 0] = val
        return out

    pts = pts.replace(
        pos=set_rows(pts.pos, slots, pos_w),
        ptype=set_rows(pts.ptype, slots, torch.where(
            good, st.TYPE_UNKNOWN, st.TYPE_DELETED).to(i32)),
        n_succ=set_rows(pts.n_succ, slots, 0),
        n_fail=set_rows(pts.n_fail, slots, 0),
        ref_kf=set_rows(pts.ref_kf, slots, 0),
        ref_px=set_rows(pts.ref_px, slots, px_ref),
        ref_level=set_rows(pts.ref_level, slots, det_level),
        ref_f=set_rows(pts.ref_f, slots, boot["f_ref"]),
        obs_kf=obs0(pts.obs_kf, torch.where(good, 0, -1).to(i32)),
        obs_f=obs0(pts.obs_f, boot["f_ref"]),
        obs_px=obs0(pts.obs_px, px_ref),
        obs_level=obs0(pts.obs_level, det_level),
        obs_count=set_rows(pts.obs_count, slots, good.to(i32)),
    )

    point_ids = torch.where(good, slots, torch.full_like(slots, -1)).to(i32)
    kfs = vo.kfs
    stack = kfs.stack.clone()
    stack[0] = ref_stack

    def row0(table, val):
        out = table.clone()
        out[0] = val
        return out

    kfs = kfs.replace(
        stack=stack, q_kw=row0(kfs.q_kw, T_ref_w.q),
        t_kw=row0(kfs.t_kw, T_ref_w.t), valid=row0(kfs.valid, True),
        frame_id=row0(kfs.frame_id, 0),
        scene_depth=row0(kfs.scene_depth, cfg.map_scale),
        ftr_px=row0(kfs.ftr_px, px_ref), ftr_f=row0(kfs.ftr_f, boot["f_ref"]),
        ftr_level=row0(kfs.ftr_level, det_level),
        ftr_point=row0(kfs.ftr_point, point_ids),
        ftr_valid=row0(kfs.ftr_valid, good))
    vo = vo.replace(points=pts, kfs=kfs,
                    kf_batch=torch.tensor(1, dtype=i32, device=dev),
                    frame_id=torch.tensor(1, dtype=i32, device=dev))

    # warped-patch cache for the bootstrap landmarks (identity warp from
    # keyframe 0), so they are matchable from the first tracked frame
    patch0, slv0, ok0 = matcher.identity_warp_patches(
        kfs.stack, torch.zeros((C,), dtype=i32, device=dev), px_ref,
        det_level, good, cfg, cam.height, cam.width)
    P = pts.pos.shape[0]
    pscat = torch.where(ok0, slots, torch.full_like(slots, P))
    pts = vo.points.replace(
        warp_patch=set_rows(vo.points.warp_patch, pscat, patch0),
        warp_level=set_rows(vo.points.warp_level, pscat, slv0),
        warp_frame=set_rows(vo.points.warp_frame, pscat, 1))
    vo = vo.replace(points=pts)

    T_cw2 = boot["T_cur_ref"].compose(T_ref_w)
    feats2 = _scatter_to_cells(boot["px_cur"], boot["f_cur"],
                               torch.zeros((C,), dtype=i32, device=dev),
                               point_ids, good, cfg, dims, cam.width)
    vo = pipeline.insert_keyframe(vo, cur_pyr, cur_stack, T_cw2, feats2,
                                  cam, cfg, dims)
    last = st.FrameState(
        stack=cur_stack, q_fw=T_cw2.q, t_fw=T_cw2.t, ftr_px=feats2["px"],
        ftr_f=feats2["f"], ftr_level=feats2["level"],
        ftr_point=feats2["point"], ftr_valid=feats2["valid"])
    return vo.replace(last=last,
                      frame_id=torch.tensor(2, dtype=i32, device=dev))


class FrameHandler:
    """Host-side VO stage machine: one `add_image` call = one processed
    frame.

    Runs on CUDA unless `device="cpu"` is given; RANSAC draws come from a
    CPU `torch.Generator` seeded with `seed`, so a run on either device
    samples the same minimal sets.  `perf_mon` (a
    `utils.profiling.PerformanceMonitor`, or None) times the stages and
    writes one trace record per frame; the spans go to the installed
    monitor (`profiling.install`), with or without a `perf_mon`.
    `n_local_ba` counts the local BA runs dispatched since the last
    reset."""

    def __init__(self, cam, cfg: SVOConfig = SVOConfig(),
                 init_T_cw: Optional[SE3] = None, seed: int = 0,
                 perf_mon=None, device=None):
        self.device = resolve_device(device)
        self.cam = for_config(cam, cfg)
        self.cfg = cfg
        self.dims = st.arena_dims(cfg, cam.width, cam.height)
        self.seed = seed
        self.perf_mon = perf_mon
        self._track = pipeline.make_track_frame(cfg, self.cam, self.dims)
        self.init_T_cw = (init_T_cw if init_T_cw is not None
                          else SE3.identity(device=self.device))
        self.reset()

    def reset(self):
        self.stage = STAGE_FIRST_FRAME
        self.vo = st.init_state(self.cfg, self.cam.width, self.cam.height,
                                device=self.device)
        self._gen = torch.Generator().manual_seed(self.seed)
        self._first = None
        self._n_fail = 0
        self._n_kf_since_ba = 0
        self.n_local_ba = 0

    def _pyr_det(self, img):
        pyr = build_pyramid(img, self.cfg.total_pyr_levels)
        det = detect.detect_features(pyr[:self.cfg.n_pyr_levels], None,
                                     self.cfg)
        return pyr, det

    def add_image(self, img, timestamp: float = 0.0) -> TrackResult:
        if self.perf_mon is None:
            with profiling.span("tot_time"):
                return self._add_image(img)
        with self.perf_mon.timer("tot_time"):
            res = self._add_image(img)
        # the monitor's own read, outside the frame and its count
        self.perf_mon.log("frame_id", int(self.vo.frame_id))
        self.perf_mon.log("stage", self.stage)
        self.perf_mon.log("result", res.result)
        self.perf_mon.log("n_matches", res.n_matches)
        self.perf_mon.log("n_edges", res.n_edges)
        self.perf_mon.log("n_seeds", res.n_seeds)
        self.perf_mon.log("n_points", res.n_points)
        self.perf_mon.write_frame()
        return res

    def _timer(self, name):
        if self.perf_mon is None:
            return profiling.span(name)
        return self.perf_mon.timer(name)

    def _frame(self, img) -> torch.Tensor:
        """The frame as float32 on the handler's device: a tensor already
        there is used as it is; a pinned host tensor is copied without
        blocking (the caller keeps it unchanged until the stream has read
        it, as the native feeder's ring does)."""
        img = torch.as_tensor(img, dtype=torch.float32)
        return img.to(self.device, non_blocking=img.is_pinned())

    def _add_image(self, img) -> TrackResult:
        img = self._frame(img)
        if self.stage == STAGE_FIRST_FRAME:
            with profiling.span("bootstrap"):
                return self._process_first(img)
        if self.stage == STAGE_SECOND_FRAME:
            with profiling.span("bootstrap"):
                return self._process_second(img)
        if self.stage in (STAGE_DEFAULT_FRAME, STAGE_RELOCALIZING):
            return self._process_default(img)
        return TrackResult(T_cw=self.init_T_cw, stage=self.stage,
                           result=pipeline.RES_NO_KEYFRAME)

    def _process_first(self, img) -> TrackResult:
        with self._timer("pyramid_creation"):
            pyr, det = self._pyr_det(img)
            n = profiling.host_read(det["valid"].sum(), "bootstrap")
        if n >= self.cfg.init_min_kps:
            self._first = (pyr, det)
            self.stage = STAGE_SECOND_FRAME
        return TrackResult(T_cw=self.init_T_cw, stage=self.stage,
                           result=pipeline.RES_IS_KEYFRAME
                           if self._first else pipeline.RES_FAILURE)

    def _process_second(self, img) -> TrackResult:
        ref_pyr, det = self._first
        cur_pyr = build_pyramid(img, self.cfg.total_pyr_levels)
        de, dh = ransac_draws(self.cfg, det["px"].shape[0], self._gen,
                              self.device)
        boot = bootstrap_pair(ref_pyr, cur_pyr, self.cam, det["px"],
                              det["valid"], self.cfg, de, dh)
        if (profiling.host_read(boot["n_tracked"], "bootstrap")
                < self.cfg.init_min_tracked):
            self.stage = STAGE_FIRST_FRAME
            self._first = None
            return TrackResult(T_cw=self.init_T_cw, stage=self.stage,
                               result=pipeline.RES_FAILURE)
        if (profiling.host_read(boot["disparity"], "bootstrap")
                < self.cfg.init_min_disparity):
            return TrackResult(T_cw=self.init_T_cw, stage=self.stage,
                               result=pipeline.RES_NO_KEYFRAME)
        if (profiling.host_read(boot["n_inliers"], "bootstrap")
                < self.cfg.init_min_inliers):
            return TrackResult(T_cw=self.init_T_cw, stage=self.stage,
                               result=pipeline.RES_NO_KEYFRAME)
        boot = dict(boot)
        boot["px_ref"] = det["px"]
        self.vo = init_map_from_bootstrap(self.vo, boot, ref_pyr, cur_pyr,
                                          self.init_T_cw, det["level"],
                                          self.cam, self.cfg, self.dims)
        self.stage = STAGE_DEFAULT_FRAME
        T_cw = boot["T_cur_ref"].compose(self.init_T_cw)
        return TrackResult(T_cw=T_cw, stage=self.stage,
                           result=pipeline.RES_IS_KEYFRAME,
                           t_wc=T_cw.inverse().t)

    def _process_default(self, img) -> TrackResult:
        was_reloc = self.stage == STAGE_RELOCALIZING
        if was_reloc:
            self._prepare_relocalization()
        with self._timer("fused_track_dispatch"):
            self.vo, out = self._track(self.vo, img)
            host = {k: profiling.host_read(out[k], "result") for k in (
                "result", "n_tracked", "n_matches", "n_edges", "n_seeds",
                "n_points")}
        result = host["result"]
        if was_reloc and host["n_tracked"] <= self.cfg.reloc_min_tracked:
            # relocalization accept gate: alignment against the closest
            # keyframe must track enough features before tracking resumes
            result = pipeline.RES_FAILURE
        if result == pipeline.RES_IS_KEYFRAME and self.cfg.loba_n_iter > 0:
            self._n_kf_since_ba += 1
            if self._n_kf_since_ba >= self.cfg.loba_every_n_kfs:
                self._n_kf_since_ba = 0
                # dispatched with no host read: the next tracking step
                # consumes the refined state in stream order
                with self._timer("local_ba"):
                    self.vo = self._run_local_ba(self.vo)
                self.n_local_ba += 1
        if result == pipeline.RES_FAILURE:
            self._n_fail += 1
            if was_reloc or self._n_fail >= 2:
                self.stage = STAGE_RELOCALIZING
        else:
            self._n_fail = 0
            self.stage = STAGE_DEFAULT_FRAME
        return TrackResult(
            T_cw=out["T_cw"], stage=self.stage, result=result,
            n_matches=host["n_matches"], n_edges=host["n_edges"],
            n_seeds=host["n_seeds"], n_points=host["n_points"],
            t_wc=out["t_wc"])

    def _run_local_ba(self, vo: st.VOState) -> st.VOState:
        """Local BA over the core keyframe window after a keyframe insertion.

        The landmark arena is compacted to `loba_point_budget` live
        landmarks (seen by at least two keyframes) before the Schur
        einsums; a frame-rotating offset round-robins which ones are
        refined when more are live than the budget.  The newest keyframe is
        the current frame, so its refined pose is propagated into `last`.
        No value is read back to the host."""
        cfg = self.cfg
        n_core = min(cfg.loba_num_kfs + 1, cfg.max_n_kfs)
        core, fixed = select_core_keyframes(
            vo.kfs.q_kw, vo.kfs.t_kw, vo.kfs.valid, vo.last.T_fw, n_core)
        pts = vo.points
        pvalid = pts.valid & (pts.obs_count >= 2)
        P = pvalid.shape[0]
        offset = (vo.frame_id.to(torch.int64) * 263) % P
        ar = torch.arange(P, device=pvalid.device)
        idx = compact(pvalid[(ar + offset) % P],
                      min(cfg.loba_point_budget, P))
        sel = idx >= 0
        idxc = (torch.clamp(idx, min=0) + offset) % P
        q2, t2, pos2_b, _ = local_ba(
            pts.pos[idxc], sel, pts.obs_kf[idxc], pts.obs_f[idxc],
            vo.kfs.q_kw, vo.kfs.t_kw, core, fixed,
            self.cam.errorMultiplier2(), cfg)
        pos2 = set_rows(pts.pos, torch.where(sel, idxc,
                                             torch.full_like(idxc, P)),
                        pos2_b)
        kfs = vo.kfs.replace(q_kw=q2, t_kw=t2)
        newest = torch.argmax(torch.where(
            kfs.valid, kfs.frame_id, torch.full_like(kfs.frame_id, -1)))
        is_cur = take_row(kfs.frame_id, newest) == (vo.frame_id - 1)
        last = vo.last.replace(
            q_fw=torch.where(is_cur, take_row(q2, newest), vo.last.q_fw),
            t_fw=torch.where(is_cur, take_row(t2, newest), vo.last.t_fw))
        return vo.replace(kfs=kfs, points=pts.replace(pos=pos2), last=last)

    def relocalize_frame_at_pose(self, kf_frame_id: int, T_cw_guess: SE3,
                                 img, timestamp: float = 0.0) -> TrackResult:
        """External relocalization hook: a place-recognition module names a
        keyframe (by frame id) and a pose guess; the tracker is seated on
        that keyframe (keeping its stored pose) and tracks `img` against it.
        The guess is only the pose reported when the keyframe is unknown."""
        vo = self.vo
        ids = vo.kfs.frame_id.cpu().numpy()
        valid = vo.kfs.valid.cpu().numpy()
        match = np.nonzero(valid & (ids == kf_frame_id))[0]
        if match.size == 0:
            return TrackResult(T_cw=T_cw_guess, stage=self.stage,
                               result=pipeline.RES_FAILURE)
        self._seat_on_keyframe(int(match[0]))
        self.stage = STAGE_DEFAULT_FRAME
        return self._process_default(self._frame(img))

    def _prepare_relocalization(self):
        """Seat the last frame on the keyframe closest to the lost pose."""
        vo = self.vo
        cam_pos = vo.last.T_fw.inverse().t
        dist = torch.linalg.norm(_kf_cam_pos(vo.kfs, slice(None)) - cam_pos,
                                 dim=-1)
        dist = torch.where(vo.kfs.valid, dist,
                           torch.full_like(dist, float("inf")))
        self._seat_on_keyframe(profiling.host_read(torch.argmin(dist),
                                                   "reloc"))

    def _seat_on_keyframe(self, k: int):
        """Make keyframe slot k (its image, stored pose and features) the
        last frame the next tracking step aligns against."""
        kfs = self.vo.kfs
        self.vo = self.vo.replace(last=st.FrameState(
            stack=kfs.stack[k], q_fw=kfs.q_kw[k], t_fw=kfs.t_kw[k],
            ftr_px=kfs.ftr_px[k], ftr_f=kfs.ftr_f[k],
            ftr_level=kfs.ftr_level[k], ftr_point=kfs.ftr_point[k],
            ftr_valid=kfs.ftr_valid[k]))
