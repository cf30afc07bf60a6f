"""Fixed-capacity structure-of-arrays state — port of
`android_svo_tpu/core/state.py` with plain dataclasses of tensors.

Point quality life cycle: TYPE_DELETED(0) -> slot free; TYPE_CANDIDATE(1)
-> converged seed awaiting keyframe adoption; TYPE_UNKNOWN(2) -> adopted,
unproven; TYPE_GOOD(3) -> enough successful reprojections.

`state_from_numpy` / `state_to_numpy` convert to and from a flat dict keyed
by the JAX dataclasses' field paths (`kfs.stack`, `points.obs_kf`,
`seeds.mu`, `last.q_fw`, `frame_id`, ...), so a state built by either
package can be handed to the other as numpy arrays.

The state's dataclasses are pytree nodes (`torch.utils._pytree`), so a
state passes through `torch.func.vmap` whole.  A batched state has a leading
batch axis on every tensor: `init_batched_state`, `stack_states` and
`unstack_state` make and split one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.utils._pytree as _pytree

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops.detect import grid_shape
from android_svo_tpu_torch.ops.pyramid import stack_shape

TYPE_DELETED = 0
TYPE_CANDIDATE = 1
TYPE_UNKNOWN = 2
TYPE_GOOD = 3


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class KeyframeArena(_Replace):
    stack: torch.Tensor        # (K, L, Hp, Wp)
    q_kw: torch.Tensor         # (K, 4) world->keyframe
    t_kw: torch.Tensor         # (K, 3)
    valid: torch.Tensor        # (K,) bool
    frame_id: torch.Tensor     # (K,) int32
    scene_depth: torch.Tensor  # (K,)
    ftr_px: torch.Tensor       # (K, C, 2)
    ftr_f: torch.Tensor        # (K, C, 3)
    ftr_level: torch.Tensor    # (K, C) int32
    ftr_point: torch.Tensor    # (K, C) int32, -1 none
    ftr_valid: torch.Tensor    # (K, C) bool


@dataclass
class PointArena(_Replace):
    pos: torch.Tensor          # (P, 3)
    ptype: torch.Tensor        # (P,) int32
    n_succ: torch.Tensor       # (P,) int32
    n_fail: torch.Tensor       # (P,) int32
    last_optim: torch.Tensor   # (P,) int32
    ref_kf: torch.Tensor       # (P,) int32
    ref_px: torch.Tensor       # (P, 2)
    ref_level: torch.Tensor    # (P,) int32
    ref_f: torch.Tensor        # (P, 3)
    ref_type: torch.Tensor     # (P,) int32
    ref_grad: torch.Tensor     # (P, 2)
    obs_kf: torch.Tensor       # (P, O) int32, -1 empty
    obs_f: torch.Tensor        # (P, O, 3)
    obs_px: torch.Tensor       # (P, O, 2)
    obs_level: torch.Tensor    # (P, O) int32
    obs_count: torch.Tensor    # (P,) int32
    warp_patch: torch.Tensor   # (P, PB, PB)
    warp_level: torch.Tensor   # (P,) int32
    warp_frame: torch.Tensor   # (P,) int32, -1 never
    warp_grad: torch.Tensor    # (P, 2)

    @property
    def valid(self) -> torch.Tensor:
        return self.ptype != TYPE_DELETED


@dataclass
class SeedArena(_Replace):
    kf: torch.Tensor           # (S,) int32
    px: torch.Tensor           # (S, 2)
    f: torch.Tensor            # (S, 3)
    level: torch.Tensor        # (S,) int32
    ftype: torch.Tensor        # (S,) int32
    grad: torch.Tensor         # (S, 2)
    a: torch.Tensor
    b: torch.Tensor
    mu: torch.Tensor
    sigma2: torch.Tensor
    z_range: torch.Tensor
    batch_id: torch.Tensor     # (S,) int32
    valid: torch.Tensor        # (S,) bool
    patch: torch.Tensor        # (S, PB, PB)
    patch_level: torch.Tensor  # (S,) int32
    patch_frame: torch.Tensor  # (S,) int32


@dataclass
class FrameState(_Replace):
    stack: torch.Tensor        # (L, Hp, Wp)
    q_fw: torch.Tensor         # (4,)
    t_fw: torch.Tensor         # (3,)
    ftr_px: torch.Tensor       # (C, 2)
    ftr_f: torch.Tensor        # (C, 3)
    ftr_level: torch.Tensor    # (C,) int32
    ftr_point: torch.Tensor    # (C,) int32
    ftr_valid: torch.Tensor    # (C,) bool

    @property
    def T_fw(self) -> SE3:
        return SE3(q=self.q_fw, t=self.t_fw)


@dataclass
class VOState(_Replace):
    kfs: KeyframeArena
    points: PointArena
    seeds: SeedArena
    last: FrameState
    frame_id: torch.Tensor        # () int32
    kf_batch: torch.Tensor        # () int32
    next_point_slot: torch.Tensor  # () int32
    pose_cov: torch.Tensor        # (6, 6)


def arena_dims(cfg: SVOConfig, width: int, height: int):
    n_rows, n_cols = grid_shape(height, width, cfg.grid_size)
    return {"K": cfg.max_n_kfs, "C": n_rows * n_cols, "P": cfg.max_points,
            "O": cfg.max_obs_per_point, "S": cfg.max_seeds,
            "PB": 2 * (cfg.patch_halfsize + 1),
            "n_rows": n_rows, "n_cols": n_cols}


def init_state(cfg: SVOConfig, width: int, height: int,
               dtype=torch.float32, device=None) -> VOState:
    dev = resolve_device(device)
    d = arena_dims(cfg, width, height)
    K, C, P, O, S, PB = d["K"], d["C"], d["P"], d["O"], d["S"], d["PB"]
    sshape = stack_shape(height, width, cfg.total_pyr_levels)
    i32 = torch.int32

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(val, *shape, dt=i32):
        return torch.full(shape, val, dtype=dt, device=dev)

    ident_q = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev)
    kfs = KeyframeArena(
        stack=z(K, *sshape), q_kw=ident_q.repeat(K, 1), t_kw=z(K, 3),
        valid=z(K, dt=torch.bool), frame_id=full(-1, K),
        scene_depth=full(1.0, K, dt=dtype), ftr_px=z(K, C, 2),
        ftr_f=z(K, C, 3), ftr_level=z(K, C, dt=i32),
        ftr_point=full(-1, K, C), ftr_valid=z(K, C, dt=torch.bool))
    points = PointArena(
        pos=z(P, 3), ptype=z(P, dt=i32), n_succ=z(P, dt=i32),
        n_fail=z(P, dt=i32), last_optim=z(P, dt=i32), ref_kf=z(P, dt=i32),
        ref_px=z(P, 2), ref_level=z(P, dt=i32), ref_f=z(P, 3),
        ref_type=z(P, dt=i32), ref_grad=z(P, 2), obs_kf=full(-1, P, O),
        obs_f=z(P, O, 3), obs_px=z(P, O, 2), obs_level=z(P, O, dt=i32),
        obs_count=z(P, dt=i32), warp_patch=z(P, PB, PB),
        warp_level=z(P, dt=i32), warp_frame=full(-1, P), warp_grad=z(P, 2))
    seeds = SeedArena(
        kf=z(S, dt=i32), px=z(S, 2), f=z(S, 3), level=z(S, dt=i32),
        ftype=z(S, dt=i32), grad=z(S, 2), a=full(1.0, S, dt=dtype),
        b=full(1.0, S, dt=dtype), mu=full(1.0, S, dt=dtype),
        sigma2=full(1.0, S, dt=dtype), z_range=full(1.0, S, dt=dtype),
        batch_id=z(S, dt=i32), valid=z(S, dt=torch.bool),
        patch=z(S, PB, PB), patch_level=z(S, dt=i32),
        patch_frame=full(-1, S))
    last = FrameState(
        stack=z(*sshape), q_fw=ident_q.clone(), t_fw=z(3), ftr_px=z(C, 2),
        ftr_f=z(C, 3), ftr_level=z(C, dt=i32), ftr_point=full(-1, C),
        ftr_valid=z(C, dt=torch.bool))
    return VOState(kfs=kfs, points=points, seeds=seeds, last=last,
                   frame_id=z(dt=i32), kf_batch=z(dt=i32),
                   next_point_slot=z(dt=i32),
                   pose_cov=torch.eye(6, dtype=dtype, device=dev))


_SUBS = {"kfs": KeyframeArena, "points": PointArena, "seeds": SeedArena,
         "last": FrameState}


def _register_pytree(cls) -> None:
    names = [f.name for f in dataclasses.fields(cls)]
    _pytree.register_pytree_node(
        cls, lambda x: ([getattr(x, n) for n in names], None),
        lambda children, _: cls(**dict(zip(names, children))))


for _cls in (*_SUBS.values(), VOState):
    _register_pytree(_cls)


def init_batched_state(cfg: SVOConfig, width: int, height: int, batch: int,
                       dtype=torch.float32, device=None) -> VOState:
    """`batch` fresh states stacked along a leading axis (real copies: the
    batched step writes into them)."""
    one = init_state(cfg, width, height, dtype=dtype, device=device)
    return _pytree.tree_map(
        lambda x: x.expand((batch,) + tuple(x.shape)).clone(), one)


def stack_states(states) -> VOState:
    """Stack per-sequence states (same config and shapes) along a new
    leading batch axis."""
    return _pytree.tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_state(vo_b: VOState) -> list:
    """The per-sequence states of a batched state (views of its rows)."""
    batch = vo_b.frame_id.shape[0]
    return [_pytree.tree_map(lambda x, i=i: x[i], vo_b) for i in range(batch)]


def field_paths() -> list:
    """Every tensor of a state by its field path, in declaration order —
    the order the JAX state's pytree flattens in."""
    out = []
    for f in dataclasses.fields(VOState):
        if f.name in _SUBS:
            out += [f"{f.name}.{g.name}"
                    for g in dataclasses.fields(_SUBS[f.name])]
        else:
            out.append(f.name)
    return out


def get_field(vo: VOState, path: str) -> torch.Tensor:
    for name in path.split("."):
        vo = getattr(vo, name)
    return vo


def state_to_numpy(vo: VOState) -> dict:
    """Flat {field path: numpy array} view of a state (copies to host), in
    `field_paths()` order."""
    return {k: get_field(vo, k).detach().cpu().numpy() for k in field_paths()}


def from_fields(d: dict) -> VOState:
    """A state from a flat {field path: tensor} dict."""
    parts = {name: cls(**{g.name: d[f"{name}.{g.name}"]
                          for g in dataclasses.fields(cls)})
             for name, cls in _SUBS.items()}
    rest = {f.name: d[f.name] for f in dataclasses.fields(VOState)
            if f.name not in _SUBS}
    return VOState(**parts, **rest)


def state_from_numpy(d: dict, device=None) -> VOState:
    """Build a state from a flat {field path: array} dict (the inverse of
    `state_to_numpy`, and the format the JAX state flattens to)."""
    dev = resolve_device(device)
    return from_fields({k: torch.from_numpy(np.array(d[k], copy=True)).to(dev)
                        for k in field_paths()})
