"""Batched multi-sequence tracking: the throughput configuration — port of
`android_svo_tpu/parallel/multi_seq.py`.

Frame-to-frame tracking is sequential per sequence (each frame's prior is
the previous frame's pose), so throughput scales by tracking B independent
sequences at once: BASELINE.json's "all 11 EuRoC sequences ... on one
host".  JAX writes it as `vmap(track_frame)`; here the step's stages
(`core/pipeline.py`) run under `torch.func.vmap` over a batched state
(`state.init_batched_state` / `stack_states`), and the two host decisions
of the single step become one read each for the whole batch:

  * sparse alignment's loop runs until every element has stopped, a
    stopped element keeping its whole carry (JAX's batched while-loop):
    on the card one launch of `sparse_align_kernel` for the batch, each
    block stopping where its own loop stops, with no read; on the CPU one
    `any(active)` read per iteration;
  * keyframe insertion runs for the batch when any element needs one
    (one `any(make_kf)` read) and commits only where that element's own
    decision holds (JAX's select of the batched `lax.cond`), writing one
    keyframe row per element.

Every patch kernel is a custom op whose vmap rule launches once for the
whole batch (`ops/patch_kernels.py`), so a step's launches do not grow with
B, and no Python loop over the sequences runs on the path.  Each element
gives what `make_track_frame` gives for that sequence alone.  A step is
one unit span `batched_step` (`utils/profiling.py`) around the stages'
spans, and its reads are `profiling.host_read`s.

`make_sharded_track` splits the batch over the mesh's "data" axis and holds
the seed and landmark arenas as row shards over "map"
(`parallel/mesh.py`).
"""

from __future__ import annotations

import torch
from torch.func import vmap

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import pipeline
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.core.state import init_batched_state  # noqa: F401
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops.sparse_align import sparse_img_align
from android_svo_tpu_torch.parallel import mesh as mesh_lib
from android_svo_tpu_torch.utils import profiling


def make_batched_track(cfg: SVOConfig, cam, dims):
    """Build `track_b(vo_b, imgs) -> (vo_b, out_b)`: the tracking step over
    a batched state and a (B, H, W) stack of frames, one per sequence; every
    value of `out_b` has a leading batch axis (`T_cw` an SE3 of (B, 4) and
    (B, 3))."""

    def step(vo_b: st.VOState, imgs: torch.Tensor):
        batch = imgs.shape[0]
        cur_pyr, cur_stack = vmap(
            lambda im: pipeline.frame_pyramid(im, cfg))(imgs)

        # STEP 1: sparse image alignment, batched loop
        with profiling.span("sparse_img_align"):
            depth_last, has_pt = vmap(pipeline.align_inputs)(vo_b)
            last = vo_b.last
            T_cur_last, n_tracked, _ = sparse_img_align(
                last.stack, cur_stack, cam,
                SE3.identity((batch,), dtype=imgs.dtype, device=imgs.device),
                last.ftr_px, last.ftr_f, depth_last, has_pt, cfg,
                batched=True)

        vo_b, feats, T_final, cov, failure, make_kf, n_matches, n_edges = \
            vmap(lambda vo, cs, T: pipeline.track_map(
                vo, cs, T, cam, cfg, dims))(vo_b, cur_stack, T_cur_last)

        # STEP 6: keyframe insertion where an element decided on one (the
        # batch's one host read)
        with profiling.span("keyframe"):
            if profiling.host_read(make_kf.any(), "keyframe"):
                vo_b = vmap(lambda vo, pyr, cs, T, ft, mk:
                            pipeline.insert_keyframe(
                                vo, pyr, cs, T, ft, cam, cfg, dims,
                                commit=mk))(
                    vo_b, cur_pyr, cur_stack, T_final, feats, make_kf)
        return vmap(pipeline.finish_frame)(
            vo_b, cur_stack, T_final, feats, cov, failure, make_kf,
            n_tracked, n_matches, n_edges)

    def track_b(vo_b: st.VOState, imgs: torch.Tensor):
        with profiling.span("batched_step"):
            return step(vo_b, imgs)

    return track_b


def make_sharded_track(cfg: SVOConfig, cam, dims, mesh):
    """The batched step over a (data, map) mesh
    (`mesh_lib.make_mesh`): returns `fn(vo_local, imgs_local) ->
    (vo_local, out_local)`.

    This rank holds its "data" rank's rows of the batch (`imgs_local` and
    every field of `vo_local`) and, of the `seeds.*` and `points.*` fields,
    its "map" rank's block of arena rows (`mesh_lib.shard_state` cuts
    both).  Each step rebuilds the full seed and landmark arenas over the
    "map" group with one `all_reduce` of a zero-filled fused buffer (XLA's
    all-gather, written out), runs `make_batched_track` on the local batch
    and keeps its own arena rows.  Every "map" rank of a "data" rank runs
    the same step on the same rows, so the replicated fields stay equal."""
    track_b = make_batched_track(cfg, cam, dims)
    group = mesh.get_group(mesh_lib.MAP_AXIS)
    n_map = mesh.size(1)
    rank = mesh.get_local_rank(mesh_lib.MAP_AXIS)

    def fn(vo_local: st.VOState, imgs_local: torch.Tensor):
        vo_full = mesh_lib.gather_arenas(vo_local, group, rank, n_map)
        vo_full, out = track_b(vo_full, imgs_local)
        return mesh_lib.keep_arena_rows(vo_full, rank, n_map), out

    return fn

