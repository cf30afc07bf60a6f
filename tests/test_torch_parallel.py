"""The port's `parallel/` held against the JAX package on the CPU:
(a) the mesh's (data, map) shape policy; (b) the sharding layout field by
field; (c) the batched tracking step against JAX's
`jax.jit(make_batched_track(...))` from three JAX-bootstrapped states whose
elements differ on the keyframe decision; (d) the batched step against
the port's own single step, element by element; (e) the patch wrappers'
batched calls per step do not grow with the batch; (f) each batched plain
kernel version against its per-frame plain version; (g) `make_sharded_ba`
in 2 and 4 gloo processes against JAX `local_ba`, one fused all-reduce per
Gauss-Newton iteration; (h) `make_sharded_track` in 2 gloo processes
against the unsharded batched step; (i) `dryrun_multichip(4)`; (j)
`compact` under vmap.

Every subprocess has its own `communicate(timeout=...)`, so a hang fails
the test instead of stalling the suite.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.core import frame_handler as jfh
from android_svo_tpu.core import state as jst
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.parallel import ba as jba
from android_svo_tpu.parallel import mesh as jmesh
from android_svo_tpu.parallel import multi_seq as jms

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import pipeline
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.core.scatter import compact
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.ops import patch_kernels as pk
from android_svo_tpu_torch.parallel import mesh as mesh_lib
from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
from android_svo_tpu_torch.tools.sharded_rank import (config_arrays,
                                                       spawn_ranks)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 240

# tests/test_parallel.py's TINY with its bootstrap thresholds for 160x120
TINY_KW = dict(max_n_kfs=4, max_points=256, max_seeds=256,
               img_align_n_iter=3, poseoptim_n_iter=2,
               structureoptim_n_iter=2, max_epi_search_steps=16,
               ransac_n_trials=8)
CFG_KW = dict(TINY_KW, init_min_kps=20, init_min_tracked=15,
              init_min_disparity=8.0, init_min_inliers=12,
              ransac_n_trials=64, min_reproj_matches=10, quality_min_fts=10,
              min_pose_opt_edges=5)
W, H = 160, 120
# each sequence's start along x: 0.75 takes a keyframe at the first batched
# frame, 0.25 at the second, 0.5 at neither
X0 = (0.25, 0.75, 0.5)
BOOT_FRAMES = 6
BATCH_FRAMES = (6, 7, 8)


def _pose(i, x0):
    return jsyn.lookdown_pose(x0 + 0.06 * i, 0.02 * i, -3.0,
                              (0.002 * i, 0.0, 0.003 * i))


def _jax_to_numpy(vo) -> dict:
    vo = jax.device_get(vo)
    out = {}
    for path in st.field_paths():
        x = vo
        for name in path.split("."):
            x = getattr(x, name)
        out[path] = np.asarray(x)
    return out


@pytest.fixture(scope="module")
def boot():
    """Three JAX FrameHandler bootstraps (one per start in X0, the handler
    reset between them) and the frames the batched steps then take."""
    jcfg = JConfig(**CFG_KW)
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(5), 1024)
    handler = jfh.FrameHandler(cam, jcfg)
    states = []
    for x0 in X0:
        handler.reset()
        for i in range(BOOT_FRAMES):
            handler.add_image(jsyn.render(tex, cam, _pose(i, x0)), 0.1 * i)
        assert handler.stage == jfh.STAGE_DEFAULT_FRAME
        assert int(jnp.sum(handler.vo.seeds.valid)) > 0
        assert int(jnp.sum(handler.vo.points.valid)) > 0
        states.append(handler.vo)
    imgs = np.stack([np.stack([np.asarray(jsyn.render(tex, cam, _pose(i, x0)))
                               for x0 in X0]) for i in BATCH_FRAMES])
    return jcfg, cam, states, imgs


@pytest.fixture(scope="module")
def jax_batched(boot):
    jcfg, cam, states, imgs = boot
    dims = jst.arena_dims(jcfg, W, H)
    step = jax.jit(jms.make_batched_track(jcfg, cam, dims))
    vo = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    outs = []
    for f in imgs:
        vo, out = step(vo, jnp.asarray(f))
        outs.append({"t": np.asarray(out["T_cw"].t),
                     "result": np.asarray(out["result"]),
                     "n_seeds": np.asarray(out["n_seeds"]),
                     "n_points": np.asarray(out["n_points"]),
                     "mu": np.asarray(vo.seeds.mu)})
    return outs


def _port_setup(boot):
    jcfg, _, states, imgs = boot
    cfg = SVOConfig(**CFG_KW)
    cam = synthetic.default_camera(W, H, device="cpu")
    dims = st.arena_dims(cfg, W, H)
    ports = [st.state_from_numpy(_jax_to_numpy(s), device="cpu")
             for s in states]
    return cfg, cam, dims, ports, torch.from_numpy(imgs)


@pytest.fixture(scope="module")
def port_batched(boot):
    cfg, cam, dims, ports, imgs = _port_setup(boot)
    track_b = make_batched_track(cfg, cam, dims)
    vo_b = st.stack_states(ports)
    outs = []
    for f in imgs:
        vo_b, out = track_b(vo_b, f)
        outs.append({"t": out["T_cw"].t.numpy(), "q": out["T_cw"].q.numpy(),
                     "result": out["result"].numpy(),
                     "n_seeds": out["n_seeds"].numpy(),
                     "n_points": out["n_points"].numpy(),
                     "mu": vo_b.seeds.mu.numpy()})
    return outs, vo_b


# ---------------------------------------------------------------------------
# (a), (b): the mesh and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_shape_matches_jax(n):
    want = jmesh.make_mesh(n).shape
    assert mesh_lib.mesh_shape(n) == (want["data"], want["map"])


@pytest.mark.parametrize("batched", [True, False])
def test_sharding_tree_matches_jax(batched):
    jcfg = JConfig(**TINY_KW)
    vo = (jms.init_batched_state(jcfg, 128, 96, 4) if batched
          else jst.init_state(jcfg, 128, 96))
    tree = jmesh.vo_sharding_tree(jmesh.make_mesh(8), vo, batched=batched)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    mine = mesh_lib.vo_sharding_tree(batched)
    assert len(flat) == len(mine)
    for path, sharding in flat:
        key = jax.tree_util.keystr(path).lstrip(".")
        spec = tuple(sharding.spec)
        want = {ax: (spec.index(ax) if ax in spec else None)
                for ax in ("data", "map")}
        assert mine[key] == want, key


# ---------------------------------------------------------------------------
# (c), (d), (e): the batched step
# ---------------------------------------------------------------------------

def test_batched_track_matches_jax_vmap(boot, jax_batched, port_batched):
    outs, _ = port_batched
    codes = np.stack([o["result"] for o in outs])
    # the batch's elements differ on the keyframe decision in a frame
    assert any(0 < (r == pipeline.RES_IS_KEYFRAME).sum() < len(X0)
               for r in codes), codes
    assert (codes != pipeline.RES_FAILURE).all(), codes
    for k, (jo, po) in enumerate(zip(jax_batched, outs)):
        np.testing.assert_array_equal(po["result"], jo["result"], err_msg=k)
        np.testing.assert_array_equal(po["n_seeds"], jo["n_seeds"],
                                      err_msg=k)
        np.testing.assert_array_equal(po["n_points"], jo["n_points"],
                                      err_msg=k)
        # camera translations: within 5e-4.  The third frame, after two
        # keyframe insertions, is where fp32 rounding has grown most: JAX's
        # own single step and its vmap step differ there by 1.0e-4, the
        # port's single step and JAX's by 2.4e-4 (the first two frames
        # agree within 2e-5); test_torch_slice.py holds tracks to 2e-3
        np.testing.assert_allclose(po["t"], jo["t"], atol=5e-4, err_msg=k)
        # seed inverse depths: to 1e-3 of their value, the bound
        # test_torch_core.py::test_update_seeds holds the single step's
        # seed update to (XLA and torch round the update's sums
        # differently; the batched step equals the single step exactly,
        # test_batched_track_matches_single_steps)
        np.testing.assert_allclose(po["mu"], jo["mu"], rtol=1e-3, atol=1e-6,
                                   err_msg=k)


VARIANTS = {"default": {},
            "lm": dict(poseoptim_method="lm", structureoptim_method="lm"),
            "edgelets": dict(edgelet_detection=True, epi_search_1d=True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_batched_track_matches_single_steps(boot, port_batched, variant):
    """Each element of the batched step against the single step on its
    sequence alone, in the default configuration, with Levenberg-Marquardt
    pose and structure optimisation, and with edgelets and the 1D epipolar
    refinement."""
    cfg, cam, dims, ports, imgs = _port_setup(boot)
    if variant == "default":
        outs, vo_b = port_batched
    else:
        cfg = cfg.replace(**VARIANTS[variant])
        track_b = make_batched_track(cfg, cam, dims)
        vo_b = st.stack_states(ports)
        outs = []
        for f in imgs:
            vo_b, out = track_b(vo_b, f)
            outs.append({"t": out["T_cw"].t.numpy(),
                         "q": out["T_cw"].q.numpy(),
                         "result": out["result"].numpy()})
    track = pipeline.make_track_frame(cfg, cam, dims)
    for b, vo in enumerate(ports):
        for k, f in enumerate(imgs):
            vo, out = track(vo, f[b])
            assert int(out["result"]) == int(outs[k]["result"][b]), (b, k)
            np.testing.assert_allclose(out["T_cw"].t.numpy(), outs[k]["t"][b],
                                       atol=1e-5, err_msg=(b, k))
            np.testing.assert_allclose(out["T_cw"].q.numpy(), outs[k]["q"][b],
                                       atol=1e-5, err_msg=(b, k))
        np.testing.assert_allclose(vo.seeds.mu.numpy(),
                                   vo_b.seeds.mu[b].numpy(), atol=1e-5)
        np.testing.assert_allclose(vo.points.pos.numpy(),
                                   vo_b.points.pos[b].numpy(), atol=1e-5)


def _count_batched_calls(monkeypatch):
    calls = {}
    for name in ("sample_patches_batched", "epi_scan_batched",
                 "align_iclk_batched", "align_iclk_mxu_batched"):
        real = getattr(pk, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(pk, name, counted)
    return calls


def test_batched_calls_do_not_grow_with_batch(boot, monkeypatch):
    """The same three sequences at B=3 and repeated to B=6: each patch
    wrapper's batched form is called as often per step (one launch per
    call on the card), so no call is made per sequence."""
    cfg, cam, dims, ports, imgs = _port_setup(boot)
    track_b = make_batched_track(cfg, cam, dims)
    counts = []
    for reps in (1, 2):
        vo_b = st.stack_states(ports * reps)
        calls = _count_batched_calls(monkeypatch)
        for f in imgs[:2]:
            vo_b, _ = track_b(vo_b, f.repeat(reps, 1, 1))
        monkeypatch.undo()
        counts.append(dict(calls))
    assert counts[0] == counts[1], counts
    assert set(counts[0]) == {"sample_patches_batched", "epi_scan_batched",
                              "align_iclk_batched",
                              "align_iclk_mxu_batched"}, counts


# ---------------------------------------------------------------------------
# (f): the batched plain versions
# ---------------------------------------------------------------------------

def _kernel_inputs(seed=0, B=3, n=40, L=3, hp=64, wp=256, h=60, w=200):
    g = torch.Generator().manual_seed(seed)
    stack = torch.rand((B, L, hp, wp), generator=g) * 255.0
    lvl = torch.randint(-1, L + 1, (B, n), generator=g, dtype=torch.int32)
    uv = torch.rand((B, n, 2), generator=g) * torch.tensor([w / 3, h / 3]) + 4
    uv[0, 0, 0] = float("nan")
    patches = torch.rand((B, n, 8, 8), generator=g) * 50.0
    valid = torch.rand((B, n), generator=g) < 0.8
    steps = torch.randint(0, 20, (B, n), generator=g, dtype=torch.int32)
    return dict(stack=stack, lvl=lvl, uv=uv, p=patches, valid=valid,
                steps=steps, h=h, w=w)


BATCHED_PLAIN = {
    "sample": (lambda x, b=None: pk.sample_patches_batched(
        x["stack"], x["lvl"], x["uv"], 4, valid=x["valid"])
        if b is None else pk.sample_patches(
            x["stack"][b], x["lvl"][b], x["uv"][b], 4, valid=x["valid"][b])),
    "sample_grad": (lambda x, b=None: pk.sample_patches_batched(
        x["stack"], x["lvl"], x["uv"], 2, grad=True)
        if b is None else pk.sample_patches(
            x["stack"][b], x["lvl"][b], x["uv"][b], 2, grad=True)),
    "epi_scan": (lambda x, b=None: pk.epi_scan_batched(
        x["stack"], x["lvl"], x["uv"], x["uv"] + 7.0, x["p"], 20, half=4,
        n_steps_each=x["steps"], h=x["h"], w=x["w"])
        if b is None else pk.epi_scan(
            x["stack"][b], x["lvl"][b], x["uv"][b], x["uv"][b] + 7.0,
            x["p"][b], 20, half=4, n_steps_each=x["steps"][b], h=x["h"],
            w=x["w"])),
    "align_iclk": (lambda x, b=None: pk.align_iclk_batched(
        x["stack"], x["lvl"], x["p"], x["p"] * 0.1, x["p"] * 0.2, x["uv"],
        x["valid"], 6, h=x["h"], w=x["w"])
        if b is None else pk.align_iclk(
            x["stack"][b], x["lvl"][b], x["p"][b], x["p"][b] * 0.1,
            x["p"][b] * 0.2, x["uv"][b], x["valid"][b], 6, h=x["h"],
            w=x["w"])),
    "align_iclk_mxu": (lambda x, b=None: pk.align_iclk_mxu_batched(
        x["stack"], x["lvl"], x["p"], x["p"] * 0.1, x["p"] * 0.2, x["uv"],
        x["valid"], 6, h=x["h"], w=x["w"], zmssd_factor=2000.0,
        min_patch_std=5.0)
        if b is None else pk.align_iclk_mxu(
            x["stack"][b], x["lvl"][b], x["p"][b], x["p"][b] * 0.1,
            x["p"][b] * 0.2, x["uv"][b], x["valid"][b], 6, h=x["h"],
            w=x["w"], zmssd_factor=2000.0, min_patch_std=5.0)),
    "dump_windows": (lambda x, b=None: pk.dump_windows_batched(
        x["stack"], x["lvl"], x["uv"], x["valid"])
        if b is None else pk.dump_windows(
            x["stack"][b], x["lvl"][b], x["uv"][b], x["valid"][b])),
}


@pytest.mark.parametrize("name", list(BATCHED_PLAIN))
def test_batched_plain_matches_per_frame_plain(name):
    x = _kernel_inputs()
    fn = BATCHED_PLAIN[name]
    out_b = fn(x)
    out_b = out_b if isinstance(out_b, tuple) else (out_b,)
    for b in range(x["stack"].shape[0]):
        one = fn(x, b)
        one = one if isinstance(one, tuple) else (one,)
        for ob, o in zip(out_b, one):
            # exactly, NaN where the per-frame version gives NaN
            torch.testing.assert_close(ob[b], o, rtol=0, atol=0,
                                       equal_nan=True, msg=f"{name} {b}")
    # and under torch.func.vmap the per-frame wrapper takes the batched path
    per = torch.func.vmap(lambda s, l, u: pk.sample_patches(s, l, u, 4))(
        x["stack"], x["lvl"], x["uv"])
    torch.testing.assert_close(per, pk.sample_patches_batched(
        x["stack"], x["lvl"], x["uv"], 4), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("stack_dim", [0, None],
                         ids=["batched_stack", "shared_stack"])
def test_vmap_of_dump_windows_takes_its_rule(stack_dim, monkeypatch):
    """torch.func.vmap over dump_windows goes through the op's vmap rule:
    one call of dump_windows_batched for the batch (one launch on the card),
    with the stack batched or shared (in_dims None: batch stride 0), and
    each frame's rows exactly the per-frame call's (both sides copy, so
    every row, dead ones too)."""
    x = _kernel_inputs()
    calls = []
    batched = pk.dump_windows_batched

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return batched(*a, **kw)

    monkeypatch.setattr(pk, "dump_windows_batched", spy)
    B = x["stack"].shape[0]
    stack = x["stack"] if stack_dim == 0 else x["stack"][1]
    wins, org = torch.func.vmap(pk.dump_windows,
                                in_dims=(stack_dim, 0, 0, 0))(
        stack, x["lvl"], x["uv"], x["valid"])
    assert calls == [(B,) + tuple(x["stack"].shape[1:])]
    assert wins.shape == (B, 40, pk.DUMP_WR, pk.DUMP_WC)
    assert org.shape == (B, 40, 2) and org.dtype == torch.int32
    for b in range(B):
        w1, o1 = pk.dump_windows(stack[b] if stack_dim == 0 else stack,
                                 x["lvl"][b], x["uv"][b], x["valid"][b])
        assert torch.equal(wins[b], w1) and torch.equal(org[b], o1), b


@pytest.fixture(scope="module")
def gate_batch():
    from android_svo_tpu_torch.ops import silicon_gate
    return silicon_gate.batched_gate_inputs(2, n=32, h=120, w=160,
                                            device="cpu")


@pytest.mark.parametrize("name", ["sample_patches_kernel",
                                  "sample_patches_kernel/grad",
                                  "sample_patches_kernel/align1d",
                                  "epi_scan_kernel", "align_iclk_kernel",
                                  "align_iclk_window_kernel",
                                  "align_iclk_window_kernel/ungated",
                                  "dump_windows_kernel"])
def test_batched_gate_calls_match_per_frame_plain(gate_batch, name):
    """The card's batched gate (`silicon_gate.batched_kernel_calls`, the
    window dump's form included) on the CPU, where each form takes its
    batched plain version: each frame's rows equal that frame's own
    `gate_calls` bit for bit, NaN where it has NaN."""
    from android_svo_tpu_torch.ops import silicon_gate
    frames, xb = gate_batch
    out = silicon_gate.batched_kernel_calls(xb)[name](True)
    out = out if isinstance(out, tuple) else (out,)
    for b, x in enumerate(frames):
        one = silicon_gate.gate_calls(x)[name](True)
        one = one if isinstance(one, tuple) else (one,)
        assert len(out) == len(one)
        for o, s1 in zip(out, one):
            assert silicon_gate.same_bits(o[b], s1), (name, b)


# ---------------------------------------------------------------------------
# (g), (h), (i): gloo processes
# ---------------------------------------------------------------------------

def _run_ranks(mode, n, n_data, src, tmp_path):
    return spawn_ranks(mode, n, n_data, str(src), str(tmp_path),
                       device="cpu", timeout=TIMEOUT)


def _jax_ba_problem(P=96, K=4, O=4):
    key = jax.random.PRNGKey(7)
    k1, k2, _ = jax.random.split(key, 3)
    pos_gt = jax.random.uniform(k1, (P, 3), jnp.float32, minval=-1.0,
                                maxval=1.0)
    pos_gt = pos_gt.at[:, 2].add(4.0)
    q_kw = jnp.tile(jnp.array([0, 0, 0, 1.0], jnp.float32), (K, 1))
    t_kw = jnp.stack([jnp.linspace(-0.5, 0.5, K), jnp.zeros((K,)),
                      jnp.zeros((K,))], axis=-1)
    from android_svo_tpu.geometry.se3 import SE3 as JSE3
    obs_f = []
    for k in range(K):
        xyz = JSE3(q=q_kw[k], t=t_kw[k]).apply(pos_gt)
        obs_f.append(xyz / jnp.linalg.norm(xyz, axis=-1, keepdims=True))
    obs_f = jnp.stack(obs_f, axis=1)
    obs_kf = jnp.tile(jnp.arange(K, dtype=jnp.int32), (P, 1))
    pos0 = pos_gt + 0.02 * jax.random.normal(k2, (P, 3), jnp.float32)
    valid = jnp.ones((P,), bool)
    core = jnp.arange(K, dtype=jnp.int32)
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    return pos0, valid, obs_kf, obs_f[:, :O], q_kw, t_kw, core, fixed


@pytest.mark.parametrize("n,n_data", [(2, 1), (4, 1), (4, 2)])
def test_sharded_ba_matches_jax_local_ba(n, n_data, tmp_path):
    jcfg = JConfig(**TINY_KW)
    focal = 120.0
    args = _jax_ba_problem()
    q_j, t_j, pos_j, chi_j = jax.jit(
        lambda *a: jba.local_ba(*a, focal=focal, cfg=jcfg))(*args)
    names = ("pos", "valid", "obs_kf", "obs_f", "q_kw", "t_kw", "core",
             "fixed")
    src = tmp_path / "ba.npz"
    np.savez(src, focal=np.asarray(focal),
             **{k: np.asarray(a) for k, a in zip(names, args)},
             **config_arrays(SVOConfig(**TINY_KW)))
    ranks = _run_ranks("ba", n, n_data, src, tmp_path)
    n_map = n // n_data
    P = args[0].shape[0]
    nc = args[6].shape[0]
    for r in ranks:
        lo, hi = r["rows"]
        assert hi - lo == P // n_map
        np.testing.assert_allclose(r["q"], np.asarray(q_j), atol=1e-5)
        np.testing.assert_allclose(r["t"], np.asarray(t_j), atol=1e-5)
        np.testing.assert_allclose(r["pos"], np.asarray(pos_j)[lo:hi],
                                   atol=1e-5)
        np.testing.assert_allclose(float(r["chi2"]), float(chi_j),
                                   rtol=1e-4, atol=1e-9)
        # one fused all-reduce per Gauss-Newton iteration, of the reduced
        # camera system's sums: 36 NC^2 + 48 NC + 1 float32
        want = 4 * (36 * nc * nc + 48 * nc + 1)
        assert r["allreduce_bytes"].tolist() == [want] * jcfg.loba_n_iter


@pytest.mark.parametrize("n_data", [1, 2])
def test_sharded_track_matches_batched(boot, port_batched, n_data,
                                       tmp_path):
    """Two gloo ranks as (data=1, map=2): the arenas split in row blocks;
    and as (data=2, map=1): the batch split.  The first batched state is
    padded to an even batch with its first sequence again."""
    cfg, cam, dims, ports, imgs = _port_setup(boot)
    vo_b = st.stack_states(ports + ports[:1])
    imgs = torch.cat([imgs, imgs[:, :1]], dim=1)
    track_b = make_batched_track(cfg, cam, dims)
    ref = []
    vo = vo_b
    for f in imgs:
        vo, o = track_b(vo, f)
        ref.append(o)
    src = tmp_path / "track.npz"
    np.savez(src, width=np.asarray(W), height=np.asarray(H),
             imgs=imgs.numpy(), **config_arrays(cfg),
             **{f"cam.{k}": getattr(cam, k).numpy()
                for k in ("fx", "fy", "cx", "cy", "dist")},
             **{f"vo.{k}": v for k, v in st.state_to_numpy(vo_b).items()})
    ranks = _run_ranks("track", 2, n_data, src, tmp_path)
    n_map = 2 // n_data
    for rank, r in enumerate(ranks):
        lo, hi = r["rows"]
        for k, o in enumerate(ref):
            np.testing.assert_allclose(r["t"][k], o["T_cw"].t[lo:hi].numpy(),
                                       atol=1e-4)
            for key in ("result", "n_seeds", "n_points"):
                np.testing.assert_array_equal(r[key][k],
                                              o[key][lo:hi].numpy())
        S = vo.seeds.mu.shape[1]
        m = rank % n_map
        blk = slice(m * S // n_map, (m + 1) * S // n_map)
        np.testing.assert_allclose(r["mu"], vo.seeds.mu[lo:hi, blk].numpy(),
                                   atol=1e-4)


def test_dryrun_multichip_four_processes():
    proc = subprocess.Popen(
        [sys.executable, "-m", "android_svo_tpu_torch.entry", "dryrun", "4"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    line = out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh={'data': 2, 'map': 2} "
                           "batch=4 result="), line
    assert "ba_chi2=" in line


# ---------------------------------------------------------------------------
# (j): compact under vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,size", [(20, 7), (64, 64), (5, 12)])
def test_compact_under_vmap(n, size):
    g = torch.Generator().manual_seed(n)
    mask = torch.rand((4, n), generator=g) < 0.4
    mask[1] = False
    out = torch.func.vmap(lambda m: compact(m, size))(mask)
    for b in range(4):
        assert torch.equal(out[b], compact(mask[b], size))
