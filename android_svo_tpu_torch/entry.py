"""Entry points: the per-frame tracking step on the card, and the
multi-device dry run — the port of `__graft_entry__.py`.

    python -m android_svo_tpu_torch.entry            # one step on the card
    python -m android_svo_tpu_torch.entry dryrun N   # N gloo processes, CPU

`entry()` builds the flagship configuration's tracking step at 640x480 on
the CUDA card (it raises without one, or runs on the CPU when given
`device="cpu"`).  `dryrun_multichip(n)` is the CPU by definition, as the
JAX package's is (that one forces n host devices): it spawns n processes
joined by a gloo group on localhost, builds the (data, map) mesh over them,
runs one batched and sharded tracking step at tiny shapes and one sharded
local BA, and prints one line.
"""

from __future__ import annotations

import socket
import sys

import torch

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.config import SVOConfig

# the JAX dry run's tiny shapes (__graft_entry__.py:59-65)
DRYRUN_CFG = SVOConfig(max_n_kfs=4, max_points=256, max_seeds=256,
                       img_align_n_iter=3, poseoptim_n_iter=2,
                       structureoptim_n_iter=2, max_epi_search_steps=16,
                       ransac_n_trials=8)
DRYRUN_W, DRYRUN_H = 128, 96


def entry(device=None):
    """Returns (fn, example_args): the per-frame tracking step of the
    default configuration on a 640x480 stream, and a fresh state and a
    blank frame on the step's device."""
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data.synthetic import default_camera

    dev = resolve_device(device)
    cfg = SVOConfig()
    cam = default_camera(640, 480, device=dev)
    dims = st.arena_dims(cfg, cam.width, cam.height)
    fn = pipeline.make_track_frame(cfg, cam, dims)
    vo = st.init_state(cfg, cam.width, cam.height, device=dev)
    img = torch.zeros((480, 640), dtype=torch.float32, device=dev)
    return fn, (vo, img)


def sparse_ba_problem(n_points: int, n_obs: int, n_kfs: int,
                      generator: torch.Generator, n_core: int = 4,
                      device=None):
    """A local BA input with the JAX dry run's observation pattern
    (__graft_entry__.py:85-101): most landmarks seen by one keyframe, about
    a third by two and a tenth by four consecutive slots (a real map's
    observation table is mostly empty), on a well-posed scene: K cameras
    along x (t from -0.5 to 0.5, no rotation), landmarks in [-1, 1]^2 x
    [3, 5], bearings with 1e-3 of noise, the positions perturbed by 0.02.
    As in the handler's local BA, only landmarks seen by at least two
    keyframes take part (`valid`; one view leaves a depth unobserved).
    The first `n_core` slots are the core window, slot 0 fixed.  Returns
    (pos, valid, obs_kf, obs_f, q_kw, t_kw, core, fixed); the draws come
    from `generator` (on the CPU), the tensors are built on `device`."""
    from android_svo_tpu_torch.geometry.se3 import SE3

    dev = resolve_device(device)
    P, O, K = n_points, n_obs, n_kfs
    pos_gt = torch.rand((P, 3), generator=generator) * 2.0 - 1.0
    pos_gt[:, 2] += 4.0
    u1 = torch.rand((P,), generator=generator)
    u2 = torch.rand((P,), generator=generator)
    n_seen = 1 + (u1 < 0.35).to(torch.int64) + (u2 < 0.1).to(torch.int64) * 2
    first = torch.randint(0, K, (P,), generator=generator)
    slot = torch.arange(O)
    obs_kf = torch.where(slot[None, :] < n_seen[:, None],
                         (first[:, None] + slot[None, :]) % K,
                         torch.full((P, O), -1))
    q_kw = torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(K, 1)
    t_kw = torch.stack([torch.linspace(-0.5, 0.5, K), torch.zeros(K),
                        torch.zeros(K)], dim=-1)
    ks = obs_kf.clamp(min=0)
    xyz = SE3(q=q_kw[ks], t=t_kw[ks]).apply(pos_gt[:, None, :])
    xyz = xyz / xyz[..., 2:3]
    # 1e-3 of bearing noise (about half a pixel): chi2 ends at the noise
    # floor, not at rounding level
    xyz[..., :2] += 1e-3 * torch.randn(xyz[..., :2].shape,
                                       generator=generator)
    obs_f = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    pos0 = pos_gt + 0.02 * torch.randn((P, 3), generator=generator)
    core = torch.arange(min(n_core, K), dtype=torch.int32)
    fixed = torch.zeros((core.shape[0],), dtype=torch.bool)
    fixed[0] = True
    out = (pos0, n_seen >= 2, obs_kf.to(torch.int32), obs_f, q_kw, t_kw,
           core, fixed)
    return tuple(x.to(dev) for x in out)


def free_port() -> int:
    """A free TCP port on localhost (for a gloo group's rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_worker(rank: int, n: int, addr: str) -> None:
    import torch.distributed as dist

    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data.synthetic import default_camera
    from android_svo_tpu_torch.parallel import mesh as mesh_lib
    from android_svo_tpu_torch.parallel.ba import make_sharded_ba
    from android_svo_tpu_torch.parallel.multi_seq import make_sharded_track

    torch.set_num_threads(1)
    mesh_lib.initialize_distributed(addr, n, rank, backend="gloo")
    try:
        cfg = DRYRUN_CFG
        cam = default_camera(DRYRUN_W, DRYRUN_H, device="cpu")
        dims = st.arena_dims(cfg, cam.width, cam.height)
        mesh = mesh_lib.make_mesh(n, device_type="cpu")
        n_data, n_map = mesh_lib.mesh_shape(n)
        d_rank = mesh.get_local_rank(mesh_lib.DATA_AXIS)
        m_rank = mesh.get_local_rank(mesh_lib.MAP_AXIS)
        batch = max(2 * n_data, 2)

        fn = make_sharded_track(cfg, cam, dims, mesh)
        vo_b = st.init_batched_state(cfg, cam.width, cam.height, batch,
                                     device="cpu")
        vo = mesh_lib.shard_state(vo_b, d_rank, n_data, m_rank, n_map)
        rows = slice(d_rank * batch // n_data,
                     (d_rank + 1) * batch // n_data)
        imgs = torch.zeros((batch, cam.height, cam.width))[rows]
        vo, out = fn(vo, imgs)
        # every data row's result codes, to every rank (one all-reduce of
        # a zero-filled buffer over the whole group, counted once per row)
        res = torch.zeros((batch,), dtype=torch.int64)
        if m_rank == 0:
            res[rows] = out["result"]
        dist.all_reduce(res)

        # distributed local BA: the landmark axis split over "map"
        P, O, K = cfg.max_points, cfg.max_obs_per_point, cfg.max_n_kfs
        prob = sparse_ba_problem(P, O, K, torch.Generator().manual_seed(0),
                                 device="cpu")
        blk = slice(m_rank * P // n_map, (m_rank + 1) * P // n_map)
        ba_fn = make_sharded_ba(cfg, 100.0, mesh)
        *_, chi2 = ba_fn(*(x[blk] for x in prob[:4]), *prob[4:])
        if rank == 0:
            print(f"dryrun_multichip OK: mesh={{'data': {n_data}, 'map': "
                  f"{n_map}}} batch={batch} result={res.tolist()} "
                  f"ba_chi2={float(chi2):.3f}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One batched, sharded tracking step and one sharded local BA over an
    n-process (data, map) mesh, on the CPU with gloo (the JAX package's dry
    run forces n CPU devices in the same way)."""
    import torch.multiprocessing as mp
    addr = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_dryrun_worker, args=(n_devices, addr),
                       nprocs=n_devices, join=True, start_method="spawn")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "dryrun":
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8)
        return 0
    fn, args = entry()
    vo, out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry OK: result={int(out['result'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
