"""Process groups, the (data, map) mesh and the sharding layout — port of
`android_svo_tpu/parallel/mesh.py` on `torch.distributed`.

The layout is the JAX package's:

  * axis "data": independent sequences tracked in parallel (the batched
    multi-sequence configuration; frame t depends on frame t-1, so this is
    the only data parallelism the domain admits);
  * axis "map": the map-scale arenas (depth-filter seeds, landmarks, local
    BA's landmark blocks) split into row blocks, the collectives running
    over the "map" group.

JAX names a sharding and XLA inserts the collectives; here the process
group is the mesh (`torch.distributed.device_mesh`), each rank holds its
block of rows, and the collectives are written out: `gather_arenas` (the
arenas' all-gather, as one all-reduce of a zero-filled fused buffer) and
`all_reduce_sum`, which `parallel/ba.py::make_sharded_ba` calls once per
Gauss-Newton iteration.  Only `all_reduce` is used, which gloo runs on CPU
and CUDA tensors alike (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.core import state as st

DATA_AXIS = "data"
MAP_AXIS = "map"


def initialize_distributed(addr: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None) -> bool:
    """Join the process group (`torch.distributed.init_process_group`).

    Arguments left None come from the usual variables: `MASTER_ADDR` and
    `MASTER_PORT` (the address becomes `tcp://host:port`), `WORLD_SIZE` and
    `RANK`.  `backend` defaults to nccl with a card and gloo without.
    Returns True when a multi-process group is up (also when it already
    was), False for the one-process no-op, so one script runs either way."""
    if dist.is_initialized():
        return True
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if addr is None or (world_size or 1) <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=addr,
                            world_size=world_size, rank=rank)
    return True


def mesh_shape(n_devices: int, data: int | None = None) -> tuple:
    """(data, map) sizes of an n-device mesh: JAX `make_mesh`'s policy,
    data = 2 when n is even and at least 4, else 1."""
    if data is None:
        data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if n_devices % data:
        raise ValueError(f"{n_devices} devices do not split into {data} "
                         f"data rows")
    return data, n_devices // data


def make_mesh(n_devices: int | None = None, data: int | None = None,
              device_type: str | None = None):
    """The 2D (data, map) DeviceMesh over the group's ranks (all of them
    unless `n_devices` says fewer), rank-major as JAX reshapes its
    devices.  On CUDA unless `device_type` says otherwise; raises without a
    card (`resolve_device`)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    shape = mesh_shape(n, data)
    return init_device_mesh(resolve_device(device_type).type, shape,
                            mesh_dim_names=(DATA_AXIS, MAP_AXIS))


def make_multihost_mesh(data: int | None = None,
                        local_world_size: int | None = None,
                        device_type: str | None = None):
    """(data, map) mesh over every process, host-major.

    Layout policy: the "data" axis (independent sequences, no collectives
    between its rows) spans hosts, and the "map" axis (the arenas' and
    local BA's collectives) stays inside a host: ranks are numbered host by
    host (`LOCAL_WORLD_SIZE`, default one rank per card, per host), and a
    mesh row is a run of consecutive ranks, so with `data` a multiple of
    the host count no row crosses a host.  One host gives `make_mesh`."""
    world = dist.get_world_size()
    if local_world_size is None:
        local_world_size = int(os.environ.get(
            "LOCAL_WORLD_SIZE", max(torch.cuda.device_count(), 1)))
    n_hosts = max(world // local_world_size, 1)
    if data is None:
        data = n_hosts
    if data % n_hosts:
        raise ValueError(f"data={data} rows would put a map row across "
                         f"hosts ({n_hosts} hosts)")
    return make_mesh(world, data, device_type)


def vo_sharding_tree(batched: bool) -> dict:
    """For every field path of a state (`state.field_paths()`), the
    dimension split over "data" (the batch, when `batched`) and the one
    split over "map" (the arena dimension of `seeds.*` and `points.*`,
    after the batch), None where a field is replicated: JAX
    `vo_sharding_tree`'s PartitionSpecs as dimensions."""
    d = 0 if batched else None
    lead = 1 if batched else 0
    out = {}
    for path in st.field_paths():
        arena = path.startswith(("seeds.", "points."))
        out[path] = {DATA_AXIS: d, MAP_AXIS: lead if arena else None}
    return out


def _arena(path: str) -> bool:
    return path.startswith(("seeds.", "points."))


def _block(n: int, rank: int, size: int) -> slice:
    if n % size:
        raise ValueError(f"{n} rows do not split into {size} blocks")
    k = n // size
    return slice(rank * k, (rank + 1) * k)


def _map_fields(vo: st.VOState, fn) -> st.VOState:
    return st.from_fields({p: fn(p, st.get_field(vo, p))
                           for p in st.field_paths()})


def shard_state(vo_b: st.VOState, data_rank: int, n_data: int,
                map_rank: int, n_map: int) -> st.VOState:
    """This rank's part of a batched state: its "data" block of the batch
    and, of the seed and landmark arenas, its "map" block of rows."""
    def cut(path, x):
        x = x[_block(x.shape[0], data_rank, n_data)]
        if _arena(path):
            x = x[:, _block(x.shape[1], map_rank, n_map)]
        return x.clone()
    return _map_fields(vo_b, cut)


def keep_arena_rows(vo_b: st.VOState, map_rank: int,
                    n_map: int) -> st.VOState:
    """A full batched state cut to this "map" rank's arena rows."""
    return _map_fields(vo_b, lambda p, x: x[:, _block(
        x.shape[1], map_rank, n_map)] if _arena(p) else x)


def all_reduce_sum(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `buf` over the group in place, one collective."""
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    if x.dtype == torch.int32:
        return x
    raise TypeError(f"no int32 image for {x.dtype}")


def _from_int32(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return x != 0
    if dtype == torch.float32:
        return x.view(torch.float32)
    return x


def gather_arenas(vo_local: st.VOState, group, map_rank: int,
                  n_map: int) -> st.VOState:
    """The full seed and landmark arenas of a "map"-sharded batched state:
    every field's rows written at this rank's block of a zero buffer, all
    fields in one int32 buffer (float32 by its bits), one all-reduce sum
    over the "map" group.  Each element has one non-zero term, so the sum
    is every rank's rows, bit for bit."""
    if n_map == 1:
        return vo_local
    paths = [p for p in st.field_paths() if _arena(p)]
    locs = [st.get_field(vo_local, p) for p in paths]
    parts = []
    for x in locs:
        b, r = x.shape[0], x.shape[1]
        z = torch.zeros((b, n_map, r) + tuple(x.shape[2:]),
                        dtype=torch.int32, device=x.device)
        z[:, map_rank] = _as_int32(x)
        parts.append(z.reshape(-1))
    buf = all_reduce_sum(torch.cat(parts), group)
    full = {}
    off = 0
    for p, x in zip(paths, locs):
        shape = (x.shape[0], n_map * x.shape[1]) + tuple(x.shape[2:])
        n = x.numel() * n_map
        full[p] = _from_int32(buf[off:off + n].reshape(shape), x.dtype)
        off += n
    return _map_fields(vo_local,
                       lambda p, x: full[p] if p in full else x)

