"""One rank of a sharded run: `make_sharded_ba` or `make_sharded_track` on
this rank's share of a problem read from a file, for the tests of
`parallel/` (gloo on the CPU) and `chip_smoke.py` phase 10 (ranks on the
card).

    python -m android_svo_tpu_torch.tools.sharded_rank MODE RANK N ADDR \
        DATA IN.npz OUT.npz [--device cuda|cpu] [--backend gloo|nccl] \
        [--repeat K] [--ckpt DIR]

MODE `ba`: IN holds the BA problem (pos, valid, obs_kf, obs_f, q_kw, t_kw,
core, fixed, focal; or several, each key prefixed `p0.`, `p1.`, ... with
`n_problems`) and `cfg.*` fields; for each, this rank takes its "map" block
of the landmarks and writes (under the same prefix) its block of pos', the
replicated q', t', chi2, the bytes of every all-reduce it made, and (with
--repeat K > 0) the median ms of K more calls.

MODE `track`: IN holds `cfg.*`, `width`/`height`, the camera's `cam.*`
(fx, fy, cx, cy, dist) and the frames `imgs` (F, B, H, W); the batched
state comes from the checkpoint directory given by --ckpt
(`utils/checkpoint.py`), or else from `vo.*` arrays; this rank takes its
"data" rows and "map" arena block, runs the F steps and writes its
outputs and its seed and landmark rows.  DATA is the mesh's "data" size,
N / DATA its "map" size.  The group is joined at ADDR
(tcp://host:port) with RANK and N as given, also for N = 1.  The rank runs
on the card unless --device cpu is given, and raises without one.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.geometry.camera import PinholeCamera
from android_svo_tpu_torch.parallel import mesh as mesh_lib
from android_svo_tpu_torch.parallel.ba import make_sharded_ba
from android_svo_tpu_torch.parallel.multi_seq import make_sharded_track
from android_svo_tpu_torch.utils.checkpoint import load_state


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_ranks(mode: str, n: int, n_data: int, src: str, out_dir: str,
                device: str | None = None, backend: str = "gloo",
                extra=(), timeout: float = 240) -> list:
    """Run this module as n processes (one per rank) joined at a free
    localhost port, on the card unless `device` says otherwise (raises
    without one); each process is waited for at most `timeout` s, and a
    rank that fails or hangs raises.  Returns each rank's outputs."""
    from android_svo_tpu_torch.entry import free_port
    device = resolve_device(device).type
    addr = f"tcp://127.0.0.1:{free_port()}"
    outs = [os.path.join(out_dir, f"{mode}_{backend}_{n}_{n_data}_{r}.npz")
            for r in range(n)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "android_svo_tpu_torch.tools.sharded_rank",
         mode, str(r), str(n), addr, str(n_data), str(src), outs[r],
         "--device", device, "--backend", backend, *extra], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, err) in enumerate(errs):
        if rc:
            raise RuntimeError(f"{mode} rank {r} ({backend}) failed rc={rc}: "
                               f"{err[-3000:]}")
    return [dict(np.load(o)) for o in outs]


def config_from(data: dict) -> SVOConfig:
    """The SVOConfig stored as `cfg.<field>` arrays (`config_arrays`)."""
    return SVOConfig(**{k[4:]: v.item() for k, v in data.items()
                        if k.startswith("cfg.")})


def config_arrays(cfg: SVOConfig) -> dict:
    return {f"cfg.{k}": np.asarray(v) for k, v in cfg.__dict__.items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_ba(mesh, m_rank, n_map, data, dev, repeat):
    if "n_problems" not in data:
        return _run_ba_one(mesh, m_rank, n_map, data, dev, repeat)
    out = {}
    for i in range(int(data["n_problems"])):
        pre = f"p{i}."
        one = {k[len(pre):]: v for k, v in data.items() if k.startswith(pre)}
        one.update({k: v for k, v in data.items() if k.startswith("cfg.")})
        res = _run_ba_one(mesh, m_rank, n_map, one, dev, repeat)
        out.update({pre + k: v for k, v in res.items()})
    return out


def _run_ba_one(mesh, m_rank, n_map, data, dev, repeat):
    sizes = []
    real = dist.all_reduce

    def counted(t, *a, **kw):
        sizes.append(t.numel() * t.element_size())
        return real(t, *a, **kw)

    P = data["pos"].shape[0]
    blk = slice(m_rank * P // n_map, (m_rank + 1) * P // n_map)
    t = {k: torch.from_numpy(data[k]).to(dev) for k in (
        "pos", "valid", "obs_kf", "obs_f", "q_kw", "t_kw", "core", "fixed")}
    args = (t["pos"][blk], t["valid"][blk], t["obs_kf"][blk],
            t["obs_f"][blk], t["q_kw"], t["t_kw"], t["core"], t["fixed"])
    fn = make_sharded_ba(config_from(data), float(data["focal"]), mesh)
    dist.all_reduce = counted
    try:
        q, tt, pos, chi2 = fn(*args)
        _sync(dev)
    finally:
        dist.all_reduce = real
    ms = []
    for _ in range(repeat):
        dist.barrier()
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"q": q.cpu().numpy(), "t": tt.cpu().numpy(),
            "pos": pos.cpu().numpy(), "chi2": chi2.cpu().numpy(),
            "rows": np.array([blk.start, blk.stop]),
            "allreduce_bytes": np.array(sizes),
            "ms": np.asarray(statistics.median(ms) if ms else np.nan)}


def run_track(mesh, d_rank, n_data, m_rank, n_map, data, dev, ckpt):
    cfg = config_from(data)
    w, h = int(data["width"]), int(data["height"])
    c = {k[4:]: data[k] for k in data if k.startswith("cam.")}
    cam = PinholeCamera.create(w, h, float(c["fx"]), float(c["fy"]),
                               float(c["cx"]), float(c["cy"]),
                               *[float(v) for v in c["dist"]], device=dev)
    dims = st.arena_dims(cfg, w, h)
    imgs = torch.from_numpy(data["imgs"])
    batch = imgs.shape[1]
    if ckpt:
        like = st.init_batched_state(cfg, w, h, batch, device=dev)
        vo_b, _ = load_state(ckpt, like)
    else:
        vo_b = st.state_from_numpy({k[3:]: data[k] for k in data
                                    if k.startswith("vo.")}, device=dev)
    rows = slice(d_rank * batch // n_data, (d_rank + 1) * batch // n_data)
    vo = mesh_lib.shard_state(vo_b, d_rank, n_data, m_rank, n_map)
    del vo_b
    fn = make_sharded_track(cfg, cam, dims, mesh)
    res = {"t": [], "result": [], "n_seeds": [], "n_points": []}
    for f in imgs:
        vo, o = fn(vo, f[rows].to(dev))
        res["t"].append(o["T_cw"].t.cpu().numpy())
        for k in ("result", "n_seeds", "n_points"):
            res[k].append(o[k].cpu().numpy())
    return {"rows": np.array([rows.start, rows.stop]),
            "mu": vo.seeds.mu.cpu().numpy(),
            "pos": vo.points.pos.cpu().numpy(),
            **{k: np.stack(v) for k, v in res.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("mode", "rank", "n", "addr", "data", "src", "out"):
        ap.add_argument(name)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    a = ap.parse_args(argv)
    rank, n, n_data = int(a.rank), int(a.n), int(a.data)
    dev = resolve_device(a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif a.backend == "nccl":
        # one card per rank
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(a.backend, init_method=a.addr, world_size=n,
                            rank=rank)
    try:
        mesh = mesh_lib.make_mesh(n, data=n_data, device_type=dev.type)
        n_map = n // n_data
        d_rank = mesh.get_local_rank(mesh_lib.DATA_AXIS)
        m_rank = mesh.get_local_rank(mesh_lib.MAP_AXIS)
        with np.load(a.src) as f:
            data = dict(f)
        if a.mode == "ba":
            out = run_ba(mesh, m_rank, n_map, data, dev, a.repeat)
        else:
            out = run_track(mesh, d_rank, n_data, m_rank, n_map, data, dev,
                            a.ckpt)
        np.savez(a.out, **out)
    finally:
        dist.destroy_process_group()
    print("OK", rank, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
