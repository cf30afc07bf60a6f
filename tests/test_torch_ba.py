"""The port's local bundle adjustment (`parallel/ba.py`), its solver
(`geometry/linsolve.solve_spd_loop`), its robust weight and the frame
handler's BA step, each against its JAX twin on the same seeded inputs.

Tolerances: BA sums the same fp32 terms in another order (torch's and
XLA's einsum contractions), so after GN iterations poses and points agree
to ~1e-5 of their scale; the stated bounds leave a factor of 10-50 over
what was measured.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.core import frame_handler as jfh
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.geometry import linsolve as jlin
from android_svo_tpu.geometry import robust as jrobust
from android_svo_tpu.geometry.se3 import SE3 as JSE3
from android_svo_tpu.parallel import ba as jba

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.geometry import linsolve, robust
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.parallel import ba

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def make_ba_problem(seed, n_kfs=6, n_pts=150, n_obs=5, noise_pose=0.02,
                    noise_pt=0.05):
    """Cameras along x at z=-3 looking at a point cloud (the scene of
    tests/test_ba.py), with some empty observation slots, some invalid
    points and two keyframes outside the core window; numpy inputs."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (n_pts, 2)),
                          rng.uniform(-0.3, 0.3, (n_pts, 1))], -1)
    q_gt, t_gt = [], []
    for i in range(n_kfs):
        T_kw = JSE3(q=jnp.array([1.0, 0, 0, 0]),
                    t=jnp.array([0.3 * i, 0.05 * i, -3.0])).inverse()
        q_gt.append(np.asarray(T_kw.q))
        t_gt.append(np.asarray(T_kw.t))
    q_gt, t_gt = np.stack(q_gt), np.stack(t_gt)
    obs_kf = np.stack([rng.permutation(n_kfs)[:n_obs]
                       for _ in range(n_pts)]).astype(np.int32)
    obs_kf[rng.random((n_pts, n_obs)) < 0.15] = -1
    T = JSE3(q=jnp.asarray(q_gt[np.maximum(obs_kf, 0)]),
             t=jnp.asarray(t_gt[np.maximum(obs_kf, 0)]))
    xyz = np.asarray(T.apply(jnp.asarray(pts[:, None, :], jnp.float32)))
    f_obs = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    dxi = rng.normal(size=(n_kfs, 6)) * noise_pose
    dxi[0] = 0.0
    T_pert = JSE3.exp(jnp.asarray(dxi, jnp.float32)).compose(
        JSE3(q=jnp.asarray(q_gt, jnp.float32),
             t=jnp.asarray(t_gt, jnp.float32)))
    pts_pert = pts + rng.normal(size=pts.shape) * noise_pt
    valid = rng.random(n_pts) > 0.1
    f32 = np.float32
    return dict(pos=pts_pert.astype(f32), valid=valid, obs_kf=obs_kf,
                obs_f=f_obs.astype(f32), q=np.asarray(T_pert.q, f32),
                t=np.asarray(T_pert.t, f32),
                core=np.array([0, 1, 2, 3], np.int32),
                fixed=np.array([True, False, False, False]),
                pts_gt=pts.astype(f32), t_gt=t_gt.astype(f32))


@pytest.mark.parametrize("n_iter", [1, 5])
def test_local_ba_matches_jax(n_iter):
    pr = make_ba_problem(7)
    args = ("pos", "valid", "obs_kf", "obs_f", "q", "t", "core", "fixed")
    jq, jt, jpos, jchi2 = jba.local_ba(
        *(jnp.asarray(pr[k]) for k in args), jnp.asarray(420.0, jnp.float32),
        JConfig(loba_n_iter=n_iter))
    q, tt, pos, chi2 = ba.local_ba(
        *(t(pr[k]) for k in args), torch.tensor(420.0),
        SVOConfig(loba_n_iter=n_iter))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-4)
    np.testing.assert_allclose(float(chi2), float(jchi2), rtol=1e-3,
                               atol=1e-9)
    # the gauge camera and the keyframes outside the core stay as they were
    np.testing.assert_array_equal(q.numpy()[[0, 4, 5]], pr["q"][[0, 4, 5]])
    # invalid points keep their positions
    np.testing.assert_array_equal(pos.numpy()[~pr["valid"]],
                                  pr["pos"][~pr["valid"]])
    if n_iter == 5:            # and the run converges toward the truth
        assert np.abs(tt.numpy()[:4] - pr["t_gt"][:4]).max() < 5e-3


def test_to_dense_is_block_diagonal():
    rng = np.random.default_rng(3)
    Hcc = t(rng.normal(size=(5, 6, 6)).astype(np.float32))
    S = ba._to_dense(Hcc, 5).numpy()
    want = np.zeros((30, 30), np.float32)
    for c in range(5):
        want[6 * c:6 * c + 6, 6 * c:6 * c + 6] = Hcc[c].numpy()
    np.testing.assert_array_equal(S, want)
    np.testing.assert_array_equal(
        S, np.asarray(jba._to_dense(jnp.asarray(Hcc.numpy()), 5,
                                    jnp.float32)))
    S_red = rng.normal(size=(5, 5, 6, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        ba._cross_to_dense(t(S_red), 5).numpy(),
        np.asarray(jba._cross_to_dense(jnp.asarray(S_red), 5)))


@pytest.mark.parametrize("case", ["spread", "few_valid", "ties"])
def test_select_core_keyframes_exact(case):
    rng = np.random.default_rng({"spread": 0, "few_valid": 1,
                                 "ties": 2}[case])
    K = 8
    q = rng.normal(size=(K, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tt = rng.normal(size=(K, 3)).astype(np.float32)
    valid = rng.random(K) > 0.3
    if case == "few_valid":
        valid[:] = False
        valid[[2, 6]] = True
    if case == "ties":
        q[:] = np.array([1, 0, 0, 0], np.float32)
        tt[:] = 0.0
        tt[::2, 0] = 1.0
        valid[:] = True
    cq = rng.normal(size=4).astype(np.float32)
    cq /= np.linalg.norm(cq)
    ct = rng.normal(size=3).astype(np.float32)
    if case == "ties":
        cq, ct = np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    jcore, jfixed = jba.select_core_keyframes(
        jnp.asarray(q), jnp.asarray(tt), jnp.asarray(valid),
        JSE3(q=jnp.asarray(cq), t=jnp.asarray(ct)), 5)
    core, fixed = ba.select_core_keyframes(t(q), t(tt), t(valid),
                                           SE3(q=t(cq), t=t(ct)), 5)
    np.testing.assert_array_equal(core.numpy(), np.asarray(jcore))
    np.testing.assert_array_equal(fixed.numpy(), np.asarray(jfixed))


def _ill_conditioned_spd(seed, d=30, cond=1e4):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    H = Q @ np.diag(np.logspace(0, np.log10(cond), d)) @ Q.T
    scale = np.logspace(-2, 3, d)[rng.permutation(d)]   # wild row scales
    H = scale[:, None] * H * scale[None, :]
    g = rng.normal(size=d) * scale
    return H.astype(np.float32), g.astype(np.float32)


def test_solve_spd_loop_matches_jax_on_ill_conditioned_system():
    H, g = _ill_conditioned_spd(11)
    x = linsolve.solve_spd_loop(t(H), t(g)).numpy()
    jx = np.asarray(jlin.solve_spd_loop(jnp.asarray(H), jnp.asarray(g)))
    x64 = np.linalg.solve(H.astype(np.float64), g.astype(np.float64))
    # both fp32 factorizations land equally close to the fp64 solution
    # (cond 1e4 after preconditioning: ~1e-3 relative in fp32)
    err_p = np.abs(x - x64) / np.abs(x64).max()
    err_j = np.abs(jx - x64) / np.abs(x64).max()
    assert err_p.max() < 1e-2 and err_j.max() < 1e-2, (err_p.max(),
                                                       err_j.max())
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-3 * np.abs(jx).max())


def test_solve_spd_loop_singular_fails_alike():
    """A zero row and column (a camera block with no observations and no
    gauge diagonal): the pivot floor makes both sides return NaN in the same
    entries — the failure local BA's cam_ok net turns into no update —
    rather than one side raising."""
    H, g = _ill_conditioned_spd(12, d=12, cond=1e2)
    H[3, :] = 0.0
    H[:, 3] = 0.0
    x = linsolve.solve_spd_loop(t(H), t(g)).numpy()
    jx = np.asarray(jlin.solve_spd_loop(jnp.asarray(H), jnp.asarray(g)))
    assert not np.isfinite(x).all()
    np.testing.assert_array_equal(np.isfinite(x), np.isfinite(jx))


def test_huber_weight_matches_jax():
    x = np.concatenate([np.linspace(-5, 5, 101), [0.0, 1.345, -1.345, 1e-14,
                                                   1e6]]).astype(np.float32)
    np.testing.assert_allclose(robust.huber_weight(t(x)).numpy(),
                               np.asarray(jrobust.huber_weight(
                                   jnp.asarray(x))), rtol=1e-6)


# ---------------------------------------------------------------------------
# the frame handler's BA step on a JAX-built state
# ---------------------------------------------------------------------------

W, H = 160, 120
CFG_KW = dict(max_n_kfs=8, max_points=512, max_seeds=512, ransac_n_trials=64,
              img_align_n_iter=8, init_min_kps=20, init_min_tracked=15,
              init_min_disparity=10.0, init_min_inliers=12,
              min_reproj_matches=10, quality_min_fts=10,
              min_pose_opt_edges=5, loba_point_budget=16)
BA_KEYS = ("points.pos", "kfs.q_kw", "kfs.t_kw", "last.q_fw", "last.t_fw")
CHAOTIC_TOL = 1e-2


def jax_state_to_numpy(vo) -> dict:
    vo = jax.device_get(vo)
    out = {}
    for f in dataclasses.fields(vo):
        val = getattr(vo, f.name)
        if dataclasses.is_dataclass(val):
            for g in dataclasses.fields(val):
                out[f"{f.name}.{g.name}"] = np.asarray(getattr(val, g.name))
        else:
            out[f.name] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def jax_handler():
    """A JAX handler (local BA on) that has bootstrapped and tracked a few
    frames of a small sweep (tests/test_map_viz.py's fixture)."""
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(11), 1024)
    handler = jfh.FrameHandler(cam, JConfig(**CFG_KW))
    for i in range(8):
        pose = jsyn.lookdown_pose(0.04 * i, 0.013 * i, -3.0,
                                  (0.001 * i, -0.001 * i, 0.002 * i))
        handler.add_image(jsyn.render(tex, cam, pose))
    assert handler.stage == jfh.STAGE_DEFAULT_FRAME
    return handler


def _compact_ba_rows(d, budget, offset):
    """The JAX handler's landmark selection (frame_handler.py:283-298) in
    numpy: live landmarks seen twice, rotated by the offset, first
    `budget`."""
    pvalid = (d["points.ptype"] > 0) & (d["points.obs_count"] >= 2)
    P = pvalid.shape[0]
    idx = np.nonzero(np.roll(pvalid, -offset))[0][:budget]
    return (idx + offset) % P


# frame ids whose offsets (frame_id * 263 mod 512 = 26 and 15) fall inside
# the fixture's live landmark slots (1..41), so the budget of 16 selects two
# different windows of them
@pytest.mark.parametrize("frame_id", [150, 185])
def test_run_local_ba_matches_jax(jax_handler, frame_id):
    """Both handlers' `_run_local_ba` on one JAX-built state whose newest
    keyframe is the current frame.  The point budget (16) is below the 24
    live landmarks, so the frame-rotating offset decides which ones BA
    refines.

    One GN iteration: this 16-landmark window with two free cameras leaves
    the monocular scale to the 1e-6 damping, so fp32 rounding alone moves
    JAX up to 1.9e-3 off the fp64 solution (measured over both frames); the
    port is held to JAX, and JAX to the port's fp64 run, within a fixed
    `CHAOTIC_TOL` = 1e-2 (5x that noise), and the port exactly to its own
    `local_ba` on the rows JAX's selection rule picks.  The tight check at
    5 iterations is `test_run_local_ba_matches_jax_well_conditioned`."""
    cfg_kw = dict(CFG_KW, loba_n_iter=1)
    jvo = jax_handler.vo
    newest = int(np.argmax(np.where(np.asarray(jvo.kfs.valid),
                                    np.asarray(jvo.kfs.frame_id), -1)))
    jvo = jvo.replace(frame_id=jnp.asarray(frame_id, jnp.int32),
                      kfs=jvo.kfs.replace(frame_id=jvo.kfs.frame_id.at[
                          newest].set(frame_id - 1)))
    d = jax_state_to_numpy(jvo)
    rows = _compact_ba_rows(d, CFG_KW["loba_point_budget"],
                            frame_id * 263 % d["points.pos"].shape[0])
    assert len(rows) == CFG_KW["loba_point_budget"]
    out_j = jax_state_to_numpy(jfh.FrameHandler(
        jax_handler.cam, JConfig(**cfg_kw))._run_local_ba(jvo))
    handler = fh.FrameHandler(synthetic.default_camera(W, H, device="cpu"),
                              SVOConfig(**cfg_kw), device="cpu")
    out_p = st.state_to_numpy(handler._run_local_ba(
        st.state_from_numpy(d, device="cpu")))

    # the same landmarks were refined: JAX's round-robin selection
    for out in (out_j, out_p):
        moved = np.nonzero(np.any(out["points.pos"] != d["points.pos"],
                                  -1))[0]
        assert set(moved) <= set(rows) and len(moved) >= len(rows) - 2
    # exactly the port's local_ba on those rows, scattered back
    core, fixed = ba.select_core_keyframes(
        t(d["kfs.q_kw"]), t(d["kfs.t_kw"]), t(d["kfs.valid"]),
        SE3(q=t(d["last.q_fw"]), t=t(d["last.t_fw"])), 5)
    q, tt, pos_b, _ = ba.local_ba(
        t(d["points.pos"][rows]), torch.ones(len(rows), dtype=torch.bool),
        t(d["points.obs_kf"][rows]), t(d["points.obs_f"][rows]),
        t(d["kfs.q_kw"]), t(d["kfs.t_kw"]), core, fixed,
        handler.cam.errorMultiplier2(), SVOConfig(**cfg_kw))
    want = d["points.pos"].copy()
    want[rows] = pos_b.numpy()
    np.testing.assert_array_equal(out_p["points.pos"], want)
    np.testing.assert_array_equal(out_p["kfs.q_kw"], q.numpy())
    # the newest keyframe is the current frame: its pose goes into `last`
    np.testing.assert_array_equal(out_p["last.q_fw"], q.numpy()[newest])
    np.testing.assert_array_equal(out_p["last.t_fw"], tt.numpy()[newest])

    # against JAX, within a fixed multiple of what fp32 rounding does to JAX
    d64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
           for k, v in d.items()}
    out_64 = st.state_to_numpy(handler._run_local_ba(
        st.state_from_numpy(d64, device="cpu")))
    for k in BA_KEYS:
        dev = np.abs(out_p[k] - out_j[k]).max()
        assert dev < CHAOTIC_TOL, (k, dev)
        # and JAX lands near the port's fp64 answer (a fault in the port's
        # algorithm would move that answer, not only its rounding)
        assert np.abs(out_j[k] - out_64[k]).max() < CHAOTIC_TOL, k
    for k in set(d) - set(BA_KEYS):
        np.testing.assert_array_equal(out_p[k], d[k], err_msg=k)


def _scene_state(d0, frame_id):
    """`d0` with its keyframes and landmarks replaced by
    `make_ba_problem`'s scene: six keyframes 10 frames apart, the newest the
    current frame, and 150 landmarks seen by up to five of them — a window
    whose scale the observations fix, unlike the fixture's."""
    pr = make_ba_problem(7)
    d = {k: v.copy() for k, v in d0.items()}
    K = pr["q"].shape[0]
    n, O = pr["obs_kf"].shape
    d["frame_id"] = np.asarray(frame_id, d["frame_id"].dtype)
    d["kfs.valid"][:] = False
    d["kfs.valid"][:K] = True
    d["kfs.q_kw"][:K] = pr["q"]
    d["kfs.t_kw"][:K] = pr["t"]
    d["kfs.frame_id"][:] = -1
    d["kfs.frame_id"][:K] = frame_id - 1 - 10 * np.arange(K)[::-1]
    d["last.q_fw"] = pr["q"][K - 1].copy()
    d["last.t_fw"] = pr["t"][K - 1].copy()
    d["points.ptype"][:] = st.TYPE_DELETED
    d["points.ptype"][:n] = np.where(pr["valid"], st.TYPE_GOOD,
                                     st.TYPE_DELETED)
    d["points.pos"][:] = 0.0
    d["points.pos"][:n] = pr["pos"]
    d["points.obs_kf"][:] = -1
    d["points.obs_kf"][:n, :O] = pr["obs_kf"]
    d["points.obs_f"][:] = 0.0
    d["points.obs_f"][:n, :O] = pr["obs_f"]
    d["points.obs_count"][:] = 0
    d["points.obs_count"][:n] = (pr["obs_kf"] >= 0).sum(1)
    return d


def _jax_state_from_numpy(d, like):
    """The JAX VOState `like` with every array replaced by `d`'s."""
    def rebuild(obj, prefix):
        return obj.replace(**{
            f.name: (rebuild(getattr(obj, f.name), f"{prefix}{f.name}.")
                     if dataclasses.is_dataclass(getattr(obj, f.name))
                     else jnp.asarray(d[prefix + f.name]))
            for f in dataclasses.fields(obj)})
    return rebuild(like, "")


# offsets 26 and 15 (frame_id * 263 mod 512) start two different windows
# of 64 among the 150 landmark slots
@pytest.mark.parametrize("frame_id", [150, 185])
def test_run_local_ba_matches_jax_well_conditioned(jax_handler, frame_id):
    """Both handlers' `_run_local_ba` at the default 5 GN iterations on a
    window with four free cameras and 64 of 135 live landmarks.  There fp32
    rounding moves JAX at most 4.9e-5 (points) and 1.8e-5 (translations)
    off the port's fp64 run, and the port at most 2.3e-5 / 8e-6 off JAX
    (measured); the port is held to JAX within fixed limits 4-10x over
    those, against BA moves of 0.23 (points) and 0.14 (translations)."""
    cfg = dict(CFG_KW, loba_n_iter=5, loba_point_budget=64)
    d = _scene_state(jax_state_to_numpy(jax_handler.vo), frame_id)
    out_j = jax_state_to_numpy(jfh.FrameHandler(
        jax_handler.cam, JConfig(**cfg))._run_local_ba(
            _jax_state_from_numpy(d, jax_handler.vo)))
    out_p = st.state_to_numpy(fh.FrameHandler(
        synthetic.default_camera(W, H, device="cpu"), SVOConfig(**cfg),
        device="cpu")._run_local_ba(st.state_from_numpy(d, device="cpu")))
    rows = _compact_ba_rows(d, 64, frame_id * 263 % d["points.pos"].shape[0])
    moved = np.nonzero(np.any(out_p["points.pos"] != d["points.pos"], -1))[0]
    assert set(moved) <= set(rows) and len(moved) >= len(rows) - 2
    assert np.abs(out_p["kfs.t_kw"] - d["kfs.t_kw"]).max() > 0.1
    np.testing.assert_allclose(out_p["points.pos"], out_j["points.pos"],
                               rtol=0, atol=2e-4)
    for k in ("kfs.t_kw", "last.t_fw"):
        np.testing.assert_allclose(out_p[k], out_j[k], rtol=0, atol=1e-4)
    for k in ("kfs.q_kw", "last.q_fw"):
        np.testing.assert_allclose(out_p[k], out_j[k], rtol=0, atol=1e-6)
    for k in set(d) - set(BA_KEYS):
        np.testing.assert_array_equal(out_p[k], d[k], err_msg=k)
