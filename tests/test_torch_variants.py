"""The tracker's other configurations in the port, held against the JAX
package on the CPU: Levenberg-Marquardt (pose, structure, sparse
alignment), edgelets (detection, the 1D alignment of `align1d_stack`, the
routing in `match_cached` and `find_match_direct`), the epipolar search
with `epi_search_1d`, the ATAN camera, `core/map_tools.py` and
`utils/checkpoint.py` — and both `track_frame`s from one JAX-built
post-bootstrap state, once with LM and once with edgelets + 1D.

Frames are rendered by the JAX package's synthetic renderer at 320x240 and
handed to the port as numpy; other inputs are numpy draws from a seed.  The
JAX functions reach their patch kernels through the plain fallback, as the
JAX package's own tests do on the CPU.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.core import frame_handler as jfh
from android_svo_tpu.core import map_tools as jmt
from android_svo_tpu.core import point_opt as jpo
from android_svo_tpu.core import pose_opt as jpose
from android_svo_tpu.core import state as jst
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.geometry.camera import ATANCamera as JATAN
from android_svo_tpu.geometry.se3 import SE3 as JSE3
from android_svo_tpu.ops import detect as jdet
from android_svo_tpu.ops import matcher as jmatch
from android_svo_tpu.ops import patch_pallas as jpp
from android_svo_tpu.ops import pyramid as jpyr
from android_svo_tpu.ops import sparse_align as jsa
from android_svo_tpu.utils import checkpoint as jckpt

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import map_tools, pipeline, point_opt
from android_svo_tpu_torch.core import pose_opt
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.geometry import ATANCamera
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import detect, matcher, sparse_align
from android_svo_tpu_torch.utils import checkpoint

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

W, H = 320, 240
CPU = torch.device("cpu")
FOCAL = 420.0
# tests/test_torch_slice.py's tracking configuration, with LM
CFG_LM = dict(max_n_kfs=8, max_points=2048, max_seeds=1024,
              ransac_n_trials=128, img_align_n_iter=15,
              init_min_disparity=20.0, loba_n_iter=0,
              poseoptim_method="lm", structureoptim_method="lm")
# tests/test_edgelet.py's relaxed thresholds for the edge-rich scene, with
# the 1D epipolar refinement; local BA off (it runs outside track_frame)
CFG_EDGE = dict(edgelet_detection=True, epi_search_1d=True, max_n_kfs=8,
                max_points=2048, max_seeds=1024, ransac_n_trials=128,
                img_align_n_iter=15, init_min_disparity=15.0,
                init_min_kps=60, init_min_tracked=30, init_min_inliers=25,
                quality_min_fts=25, min_reproj_matches=20,
                min_pose_opt_edges=12, kfselect_mindist=0.03, loba_n_iter=0)
N_FRAMES = 11          # bootstrap lands on frame 4; frames 5..10 tracked


def t(a):
    return torch.from_numpy(np.array(a))


def jit(fn, **static):
    """A JAX function compiled once with its configuration (and other
    static arguments) fixed: one XLA compile instead of one per eager op."""
    return jax.jit(partial(fn, **static))


def close(a, b, atol=1e-4, rtol=1e-5):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


def pse3(T):
    return SE3(q=t(T.q), t=t(T.t))


def _twist_pose(xi):
    T = JSE3.exp(jnp.asarray(xi, jnp.float32))
    return T, pse3(T)


def edge_image():
    """tests/test_edgelet.py's horizontal intensity step (no corners)."""
    ramp = jax.nn.sigmoid((jnp.arange(H) - H / 2) / 1.5) * 200.0
    return np.asarray(jnp.zeros((H, W), jnp.float32) + ramp[:, None])


@pytest.fixture(scope="module")
def frames():
    """Frames of the noise texture: tests/test_torch_ops.py's two, and a
    third five steps on (a baseline that conditions triangulation)."""
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(11), 1024)
    poses = [jsyn.lookdown_pose(0.03 * i, 0.01 * i, -3.0,
                                (0.45 + 0.002 * i, -0.002 * i, 0.0))
             for i in (0, 1, 5)]
    return cam, [np.asarray(jsyn.render(tex, cam, p)) for p in poses], poses


@pytest.fixture(scope="module")
def pcam():
    return synthetic.default_camera(W, H, device="cpu")


def _edge_poses(n):
    return [jsyn.lookdown_pose(0.04 * i, 0.012 * i, -3.0,
                               (0.45 + 0.002 * i, -0.002 * i, 0.004 * i))
            for i in range(n)]


@pytest.fixture(scope="module")
def edge_seq():
    """tests/test_edgelet.py's edge-rich scene and pose sweep."""
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_edge_texture(jax.random.PRNGKey(3), 2048)
    poses = _edge_poses(N_FRAMES)
    return cam, [np.asarray(jsyn.render(tex, cam, p)) for p in poses], poses


# ---------------------------------------------------------------------------
# Levenberg-Marquardt
# ---------------------------------------------------------------------------

def test_optimize_pose_lm():
    """Pose LM on 160 matches with pixel noise and 10% outliers from a
    perturbed start (the tolerances of test_torch_core's GN case)."""
    rng = np.random.default_rng(21)
    c = 160
    z = rng.uniform(2.0, 5.0, c)
    p_c = np.stack([rng.uniform(-1, 1, c) * z, rng.uniform(-0.7, 0.7, c) * z,
                    z], -1).astype(np.float32)
    Tt, _ = _twist_pose([0.05, -0.02, 0.1, 0.02, -0.01, 0.03])
    p_w = np.asarray(Tt.inverse().apply(p_c))
    f = p_c / p_c[:, 2:3]
    f[:, :2] += rng.normal(0, 0.5 / FOCAL, (c, 2))
    out = rng.random(c) < 0.1
    f[out, :2] += rng.normal(0, 20 / FOCAL, (out.sum(), 2))
    f = (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(np.float32)
    level = rng.integers(0, 3, c).astype(np.int32)
    valid = rng.random(c) < 0.95
    T0j, T0p = _twist_pose([0.07, -0.04, 0.13, 0.035, -0.02, 0.01])
    jcfg, cfg = JConfig(poseoptim_method="lm"), SVOConfig(
        poseoptim_method="lm")
    rj = jax.jit(partial(jpose.optimize_pose, cfg=jcfg))(
        T0j, p_w, f, level, valid, focal=jnp.float32(FOCAL))
    rp = pose_opt.optimize_pose(T0p, t(p_w), t(f), t(level), t(valid),
                                torch.tensor(FOCAL), cfg)
    close(rp[0].q, rj[0].q, atol=1e-5)
    close(rp[0].t, rj[0].t, atol=1e-5)
    assert (rp[1].numpy() != np.asarray(rj[1])).sum() <= 1
    assert abs(int(rp[2]) - int(rj[2])) <= 1
    close(rp[3], rj[3], rtol=1e-3, atol=1e-9)
    # and LM found the pose
    close(rp[0].t, Tt.t, atol=5e-3)


def test_optimize_points_lm():
    """Per-point LM on 30 points seen from 4 keyframes each (the tolerances
    of test_torch_core's GN case)."""
    rng = np.random.default_rng(22)
    b, o = 30, 4
    pos = np.stack([rng.uniform(-1, 1, b), rng.uniform(-1, 1, b),
                    rng.uniform(0.5, 2.0, b)], -1).astype(np.float32)
    # keyframes 0.5 apart (sd) at ~2 in front of the points, 0.1 rad turns
    xi = rng.normal(0, 0.1, (b, o, 6)).astype(np.float32)
    xi[..., :3] *= 5.0
    xi[..., 2] += 2.0
    T = JSE3.exp(jnp.asarray(xi))
    p_f = np.asarray(T.apply(jnp.asarray(pos)[:, None, :]))
    f = p_f / p_f[..., 2:3]
    f[..., :2] += rng.normal(0, 1.0 / FOCAL, (b, o, 2))
    f = (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(np.float32)
    obs_valid = rng.random((b, o)) < 0.85
    obs_valid[:, :2] = True
    point_valid = rng.random(b) < 0.9
    start = (pos + rng.normal(0, 0.08, pos.shape)).astype(np.float32)
    args = (start, np.asarray(T.q), np.asarray(T.t), f, obs_valid,
            point_valid)
    pj, cj = jpo.optimize_points(*args, 5, method="lm")
    pp_, cp = point_opt.optimize_points(*[t(a) for a in args], 5,
                                        method="lm")
    close(pp_, pj, atol=1e-4)
    close(cp, cj, rtol=1e-3, atol=1e-9)
    # the damped steps still improve every live point
    chi0 = point_opt.optimize_points(*[t(a) for a in args], 0)[1]
    assert (cp.numpy()[point_valid] <= chi0.numpy()[point_valid]).all()


def _align_problem(frames, pcam, eps):
    jc, imgs, poses = frames
    jcfg = JConfig(img_align_eps=eps, img_align_n_iter=15)
    cfg = SVOConfig(img_align_eps=eps, img_align_n_iter=15)
    s0 = jpyr.build_stack(imgs[0], 5)
    s1 = jpyr.build_stack(imgs[1], 5)
    det = jit(jdet.detect_features, cfg=jcfg)(jpyr.build_pyramid(imgs[0], 3),
                                              None)
    px = det["px"]
    f = jc.cam2world(px)
    d = jsyn.true_depth(jc, poses[0], px)
    jargs = (s0, s1, jc, JSE3.identity(), px, f, d, det["valid"], jcfg)
    pargs = (t(s0), t(s1), pcam, SE3.identity(), t(px), t(f), t(d),
             t(det["valid"]), cfg)
    return jargs, pargs


# eps=1e-3 ends levels on the `small` update (the only exit LM has besides
# the iteration cap); 1e-7 runs the cap.  Poses: test_torch_ops' GN bars.
@pytest.mark.parametrize("eps,tol", [(1e-7, 1e-5), (1e-3, 3e-5)])
def test_sparse_img_align_lm(frames, pcam, eps, tol):
    jargs, pargs = _align_problem(frames, pcam, eps)
    # eager, as test_torch_ops' GN case: XLA's fusion under jit moves the
    # JAX iterate by ~1e-5
    Tj, nj, cj = jsa.sparse_img_align(*jargs, method="lm")
    Tp, np_, cp = sparse_align.sparse_img_align(*pargs, method="lm")
    close(Tp.q, Tj.q, atol=tol)
    close(Tp.t, Tj.t, atol=tol)
    assert abs(int(np_) - int(nj)) <= 1
    close(cp, cj, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# 1D alignment, the epipolar search with epi_search_1d
# ---------------------------------------------------------------------------

def _align1d_inputs(image, on_edge):
    """Reference patches at true positions and a start displaced along a
    per-feature direction: on the edge image 8 features on the edge, moved
    along its gradient (tests/test_edgelet.py), on the noise texture 48
    features at random levels and directions."""
    stack = np.asarray(jpyr.build_stack(jnp.asarray(image), 3))
    rng = np.random.default_rng(23)
    if on_edge:
        n = 8
        lvl = np.zeros(n, np.int32)
        uv = np.stack([np.linspace(40, W - 40, n), np.full(n, H / 2 + 0.3)],
                      -1).astype(np.float32)
        direction = np.tile([[0.0, 1.0]], (n, 1)).astype(np.float32)
    else:
        n = 48
        lvl = rng.integers(0, 3, n).astype(np.int32)
        wl, hl = W >> lvl, H >> lvl
        uv = np.stack([14 + rng.random(n) * (wl - 28),
                       14 + rng.random(n) * (hl - 28)], -1).astype(np.float32)
        ang = rng.random(n) * 2 * np.pi
        direction = np.stack([np.cos(ang), np.sin(ang)], -1).astype(
            np.float32)
    ref, gx, gy = jit(jpp.sample_patches, half=5, grad=True,
                      use_pallas=False)(stack, lvl, uv)
    ref, gx, gy = (np.asarray(a)[:, 1:-1, 1:-1] for a in (ref, gx, gy))
    init = (uv + 1.5 * direction).astype(np.float32)
    valid = np.ones(len(uv), bool)
    valid[-1] = False                              # a dead slot stays put
    return stack, lvl, ref, gx, gy, direction, init, valid, uv


@pytest.mark.parametrize("scene", ["edge", "texture"])
def test_align1d_stack(frames, scene):
    image = edge_image() if scene == "edge" else frames[1][0]
    stack, lvl, ref, gx, gy, d, init, valid, uv = _align1d_inputs(
        image, scene == "edge")
    uj, cj, mj = jit(jmatch.align1d_stack, n_iter=10, h=H, w=W,
                     use_pallas=False)(stack, lvl, ref, gx, gy, d, init, valid)
    up, cp, mp = matcher.align1d_stack(t(stack), t(lvl), t(ref), t(gx),
                                       t(gy), t(d), t(init), t(valid), 10,
                                       H, W)
    cj = np.asarray(cj)
    np.testing.assert_array_equal(cp.numpy(), cj)
    close(up, uj, atol=1e-3)
    close(mp.numpy()[cj], np.asarray(mj)[cj], atol=1e-2)
    assert cj.sum() >= 0.5 * valid.sum()
    # the converged features moved back to their true position
    err = np.linalg.norm(up.numpy()[cj] - uv[cj], axis=-1)
    assert np.median(err) < 0.1, err


def test_find_epipolar_match_1d(frames, pcam):
    """The seed update's search with the 1D refinement along the epipolar
    segment, for 40 features with true depths between frames 0 and 2
    (test_torch_ops' 2D case's bars; the 1D step cannot correct across the
    segment, so the depths are right to 5%, not 2%)."""
    jc, imgs, poses = frames
    stk = jpyr.build_stack(imgs[0], 5)[None]
    cur = jpyr.build_stack(imgs[2], 5)
    rng = np.random.default_rng(6)
    n = 40
    px = (30 + rng.random((n, 2)) * [W - 60, H - 60]).astype(np.float32)
    lvl = rng.integers(0, 3, n).astype(np.int32)
    f = np.asarray(jc.cam2world(px))
    d = np.asarray(jsyn.true_depth(jc, poses[0], px))
    Tj = poses[2].inverse().compose(poses[0])
    kf, valid = np.zeros(n, np.int32), np.ones(n, bool)
    jcfg, cfg = JConfig(epi_search_1d=True), SVOConfig(epi_search_1d=True)
    pb, sl, _, ok = jit(jmatch.compute_warp_batch, cfg=jcfg)(
        stk, kf, jc, px, f, d, lvl, Tj, valid)
    d_min = (d * 0.8).astype(np.float32)
    d_max = (d * 1.25).astype(np.float32)
    dj, pj, sj = jit(jmatch.find_epipolar_match, cfg=jcfg)(
        cur, stk, kf, jc, px, f, lvl, Tj, d, d_min, d_max, ok,
        cached=(pb, sl))
    dp, pp_, sp = matcher.find_epipolar_match(
        t(cur), t(stk), t(kf), pcam, t(px), t(f), t(lvl), pse3(Tj), t(d),
        t(d_min), t(d_max), t(ok), cfg, cached=(t(pb), t(sl)))
    sj = np.asarray(sj)
    assert (sj == sp.numpy()).mean() >= 0.95
    both = sj & sp.numpy()
    assert both.sum() >= 0.5 * len(sj)
    close(dp.numpy()[both], np.asarray(dj)[both], atol=2e-3, rtol=1e-3)
    close(pp_.numpy()[both], np.asarray(pj)[both], atol=2e-2)
    rel = np.abs(dp.numpy()[both] / d[both] - 1.0)
    assert np.median(rel) < 0.05


# ---------------------------------------------------------------------------
# edgelets: detection, texture, matching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["edge", "noise"])
def test_detect_edgelets(scene):
    """The edgelet fallback on a pure edge (every detection an edgelet) and
    on noise (corners win): >= 97% of cells identical, as the corner
    detection's parity test."""
    if scene == "edge":
        img = edge_image()
    else:
        img = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (H, W),
                                            jnp.float32) * 255.0)
    jcfg = JConfig(edgelet_detection=True)
    cfg = SVOConfig(edgelet_detection=True)
    jpyr_ = jpyr.build_pyramid(jnp.asarray(img), jcfg.total_pyr_levels)
    dj = jit(jdet.detect_features, cfg=jcfg)(jpyr_[:jcfg.n_pyr_levels],
                                             None)
    dp = detect.detect_features(
        tuple(t(a) for a in jpyr_[:cfg.n_pyr_levels]), None, cfg)
    same = ((dp["valid"].numpy() == np.asarray(dj["valid"]))
            & (dp["ftype"].numpy() == np.asarray(dj["ftype"]))
            & (dp["level"].numpy() == np.asarray(dj["level"])))
    assert same.mean() >= 0.97, same.mean()
    both = same & np.asarray(dj["valid"])
    close(dp["px"].numpy()[both], np.asarray(dj["px"])[both], atol=1e-4)
    close(dp["grad"].numpy()[both], np.asarray(dj["grad"])[both], atol=1e-4)
    close(dp["score"].numpy()[both], np.asarray(dj["score"])[both],
          rtol=1e-3, atol=1e-2)
    valid = dp["valid"].numpy()
    edges = dp["ftype"].numpy()[valid] == detect.FTYPE_EDGELET
    if scene == "edge":
        assert valid.sum() > 10 and edges.all()
        assert (np.abs(dp["grad"].numpy()[valid][:, 1]) > 0.95).all()
    else:
        assert edges.mean() < 0.1


def test_make_edge_texture_outside_band():
    """The rings, ramp and clip are deterministic: outside the noise band
    the port's texture equals the JAX one exactly."""
    size = 512
    tj = np.asarray(jsyn.make_edge_texture(jax.random.PRNGKey(3), size))
    tp = synthetic.make_edge_texture(torch.Generator().manual_seed(3), size,
                                     device="cpu").numpy()
    yy = np.arange(size, dtype=np.float32)[:, None] / size
    band = np.abs(yy - 0.5) < 0.18 / 2
    out = np.broadcast_to(~band, tj.shape)
    np.testing.assert_array_equal(tp[out], tj[out])
    assert tp.shape == tj.shape and tp.dtype == tj.dtype
    assert np.isfinite(tp).all() and tp.min() >= 0 and tp.max() <= 255


@pytest.fixture(scope="module")
def edge_match(edge_seq):
    """Features detected with the edgelet fallback on frame 0 of the edge
    scene (corners in the noise band, edgelets on the rings), true depths,
    and the warp to frame 2."""
    jc, imgs, poses = edge_seq
    jcfg = JConfig(edgelet_detection=True)
    pyr0 = jpyr.build_pyramid(jnp.asarray(imgs[0]), jcfg.total_pyr_levels)
    det = jit(jdet.detect_features, cfg=jcfg)(pyr0[:jcfg.n_pyr_levels], None)
    keep = np.nonzero(np.asarray(det["valid"]))[0]
    px = np.asarray(det["px"])[keep]
    n = len(px)
    stk = jpyr.build_stack(jnp.asarray(imgs[0]), 5)[None]
    cur = jpyr.build_stack(jnp.asarray(imgs[2]), 5)
    f = np.asarray(jc.cam2world(px))
    d = np.asarray(jsyn.true_depth(jc, poses[0], px))
    Tj = poses[2].inverse().compose(poses[0])
    p_cur = np.asarray(jc.world2cam(Tj.apply(f * d[:, None])))
    return dict(stk=stk, cur=cur, px=px, f=f, d=d, Tj=Tj, Tp=pse3(Tj),
                lvl=np.asarray(det["level"])[keep],
                ftype=np.asarray(det["ftype"])[keep],
                grad=np.asarray(det["grad"])[keep], kf=np.zeros(n, np.int32),
                valid=np.ones(n, bool), init=(p_cur + 0.7).astype(np.float32),
                p_cur=p_cur)


def _match_agree(sj, pj, sp, pp_):
    """Success flags agree on >= 95% of features; positions (level-0 px)
    within 2e-2 where both succeed (test_torch_ops' match bars)."""
    sj = np.asarray(sj)
    sp = sp.numpy()
    assert (sj == sp).mean() >= 0.95, (sj != sp).sum()
    both = sj & sp
    assert both.sum() >= 10
    close(pp_.numpy()[both], np.asarray(pj)[both], atol=2e-2)
    return both


@pytest.mark.parametrize("align_mxu", [True, False])
def test_match_cached_edgelets(edge_seq, pcam, edge_match, align_mxu):
    """match_cached's edgelet branch: the window ICLK runs ungated (corners
    too), edgelets align 1D along the warped gradient, and every match
    passes the separate ZMSSD gate; both feature-align schedules."""
    x = edge_match
    jc = edge_seq[0]
    kw = dict(edgelet_detection=True, align_mxu=align_mxu)
    jcfg, cfg = JConfig(**kw), SVOConfig(**kw)
    pb, sl, gj, ok = jit(jmatch.compute_warp_batch, cfg=jcfg)(
        x["stk"], x["kf"], jc, x["px"], x["f"], x["d"], x["lvl"], x["Tj"],
        x["valid"], ref_grad=x["grad"])
    pb_p, sl_p, gp, ok_p = matcher.compute_warp_batch(
        t(x["stk"]), t(x["kf"]), pcam, t(x["px"]), t(x["f"]), t(x["d"]),
        t(x["lvl"]), x["Tp"], t(x["valid"]), cfg, ref_grad=t(x["grad"]))
    close(gp, gj, atol=1e-4)
    close(ok_p, ok)
    pj, sj = jit(jmatch.match_cached, cfg=jcfg)(
        x["cur"], jc, pb, sl, x["init"], ok, warp_grad=gj,
        ref_type=x["ftype"])
    pp_, sp = matcher.match_cached(t(x["cur"]), pcam, t(pb), t(sl),
                                   t(x["init"]), t(ok), cfg,
                                   warp_grad=t(gj), ref_type=t(x["ftype"]))
    edge = x["ftype"] == detect.FTYPE_EDGELET
    both = _match_agree(sj, pj, sp, pp_)
    assert (both & edge).sum() >= 5
    # an edgelet is only located along its gradient: check that component
    g = np.asarray(gj)[both & edge]
    err = np.abs(np.sum((pp_.numpy() - x["p_cur"])[both & edge] * g, -1))
    assert np.median(err) < 0.3, err


@pytest.mark.parametrize("routed", [True, False])
def test_find_match_direct(edge_seq, pcam, edge_match, routed):
    """The uncached direct match, with edgelet routing (direction A @
    ref_grad) and without (2D ICLK for every feature, gates inline)."""
    x = edge_match
    jc = edge_seq[0]
    jcfg = JConfig(edgelet_detection=routed)
    cfg = SVOConfig(edgelet_detection=routed)
    kw_j = dict(ref_grad=x["grad"], ref_type=x["ftype"]) if routed else {}
    kw_p = dict(ref_grad=t(x["grad"]), ref_type=t(x["ftype"])) \
        if routed else {}
    pj, lj, sj = jit(jmatch.find_match_direct, cfg=jcfg)(
        x["cur"], x["stk"], x["kf"], jc, x["px"], x["f"], x["d"], x["lvl"],
        x["Tj"], x["init"], x["valid"], **kw_j)
    pp_, lp, sp = matcher.find_match_direct(
        t(x["cur"]), t(x["stk"]), t(x["kf"]), pcam, t(x["px"]), t(x["f"]),
        t(x["d"]), t(x["lvl"]), x["Tp"], t(x["init"]), t(x["valid"]), cfg,
        **kw_p)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    both = _match_agree(sj, pj, sp, pp_)
    edge = x["ftype"] == detect.FTYPE_EDGELET
    if routed:
        assert (both & edge).sum() >= 5
    else:
        err = np.linalg.norm(pp_.numpy()[both] - x["p_cur"][both], axis=-1)
        assert np.median(err) < 0.3, err


def test_find_match_direct_edge_image(pcam):
    """tests/test_edgelet.py's routing case in both packages: identity
    pose, edge features displaced 2 px along the gradient."""
    stack = jpyr.build_stack(jnp.asarray(edge_image()), 3)
    jc = jsyn.default_camera(W, H)
    n = 8
    px_ref = np.stack([np.linspace(40, W - 40, n), np.full(n, H / 2 + 0.3)],
                      -1).astype(np.float32)
    f_ref = np.asarray(jc.cam2world(px_ref))
    depth = np.full(n, 3.0, np.float32)
    grad = np.tile([[0.0, 1.0]], (n, 1)).astype(np.float32)
    ftype = np.full(n, detect.FTYPE_EDGELET, np.int32)
    init = (px_ref + [0.0, 2.0]).astype(np.float32)
    zi, ones = np.zeros(n, np.int32), np.ones(n, bool)
    jcfg, cfg = JConfig(edgelet_detection=True), SVOConfig(
        edgelet_detection=True)
    pj, _, sj = jit(jmatch.find_match_direct, cfg=jcfg)(
        stack, stack[None], zi, jc, px_ref, f_ref, depth, zi,
        JSE3.identity(), init, ones, ref_grad=grad, ref_type=ftype)
    pp_, _, sp = matcher.find_match_direct(
        t(stack), t(stack[None]), t(zi), pcam, t(px_ref), t(f_ref),
        t(depth), t(zi), SE3.identity(), t(init), t(ones), cfg,
        ref_grad=t(grad), ref_type=t(ftype))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    close(pp_, pj, atol=1e-3)
    ok = sp.numpy()
    assert ok.sum() >= n - 1
    assert np.median(np.abs(pp_.numpy()[ok, 1] - px_ref[ok, 1])) < 0.2


# ---------------------------------------------------------------------------
# the ATAN camera
# ---------------------------------------------------------------------------

ATAN_ARGS = (752, 480, 400.0, 400.0, 376.0, 240.0, 0.93)


def test_atan_projection_roundtrip():
    jc = JATAN.create(*ATAN_ARGS)
    pc = ATANCamera.create(*ATAN_ARGS)
    rng = np.random.default_rng(24)
    px = (rng.random((128, 2)) * [700.0, 440.0] + 20.0).astype(np.float32)
    px[0] = [376.0, 240.0]                     # the centre: r = 0 branch
    close(pc.cam2world(t(px)), jc.cam2world(px), atol=0, rtol=1e-5)
    xyz = np.concatenate([rng.normal(0, 1, (64, 2)),
                          rng.uniform(1, 4, (64, 1))], -1).astype(np.float32)
    xyz[0] = [0.0, 0.0, 2.0]
    close(pc.world2cam(t(xyz)), jc.world2cam(xyz), atol=0, rtol=1e-5)
    close(pc.world2cam(pc.cam2world(t(px))), px, atol=0.05)
    assert float(pc.errorMultiplier2()) == float(jc.errorMultiplier2())
    for kw in ({}, {"boundary": 30.0}, {"level": 1}):
        np.testing.assert_array_equal(pc.is_in_frame(t(px), **kw).numpy(),
                                      np.asarray(jc.is_in_frame(px, **kw)))


def test_atan_warp_matrix_affine():
    """The affine warp through an ATAN camera (rtol 1e-5)."""
    jc = JATAN.create(*ATAN_ARGS)
    pc = ATANCamera.create(*ATAN_ARGS)
    rng = np.random.default_rng(25)
    n = 32
    px = (40 + rng.random((n, 2)) * [670.0, 400.0]).astype(np.float32)
    lvl = rng.integers(0, 3, n).astype(np.int32)
    f = np.asarray(jc.cam2world(px))
    d = rng.uniform(1.5, 4.0, n).astype(np.float32)
    Tj, Tp = _twist_pose([0.05, -0.02, 0.03, 0.02, 0.01, -0.03])
    Aj = jit(jmatch.get_warp_matrix_affine, halfpatch=4)(jc, px, f, d, Tj,
                                                         lvl)
    Ap = matcher.get_warp_matrix_affine(pc, t(px), t(f), t(d), Tp, t(lvl), 4)
    close(Ap, Aj, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: track_frame with LM and with edgelets + 1D
# ---------------------------------------------------------------------------

def _jax_state_to_numpy(vo) -> dict:
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


def _jax_run(cam, imgs, cfg_kw):
    """The JAX FrameHandler over the frames: the state right after the
    bootstrap, every tracked frame's outputs, and the final handler."""
    handler = jfh.FrameHandler(cam, JConfig(**cfg_kw))
    boot_state, outs = None, []
    for img in imgs:
        was_default = handler.stage == jfh.STAGE_DEFAULT_FRAME
        res = handler.add_image(jnp.asarray(img))
        if not was_default and handler.stage == jfh.STAGE_DEFAULT_FRAME:
            boot_state = _jax_state_to_numpy(handler.vo)
        elif was_default:
            outs.append({"result": res.result, "n_matches": res.n_matches,
                         "n_edges": res.n_edges,
                         "q": np.asarray(res.T_cw.q),
                         "t_wc": np.asarray(res.t_wc)})
    assert boot_state is not None, "JAX handler did not bootstrap"
    return boot_state, outs, handler


@pytest.fixture(scope="module")
def lm_run():
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(11), 2048)
    imgs = [np.asarray(jsyn.render(tex, cam, jsyn.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0,
        (0.45 + 0.002 * i, -0.002 * i, 0.004 * i)))) for i in range(N_FRAMES)]
    return (imgs,) + _jax_run(cam, imgs, CFG_LM)


@pytest.fixture(scope="module")
def edge_run(edge_seq):
    _, imgs, _ = edge_seq
    return (imgs,) + _jax_run(edge_seq[0], imgs, CFG_EDGE)


def _quat_angle(q1, q2):
    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return 2.0 * np.arccos(min(d, 1.0))


@pytest.mark.parametrize("variant", ["lm", "edgelets_1d"])
def test_track_frames_agree(request, pcam, variant):
    """Both track_frames from one JAX-built post-bootstrap state
    (test_torch_slice's bars): result codes equal, match and edge counts
    within 3 or 3%, camera centres within 2e-3, rotations within 1e-3 rad."""
    run = request.getfixturevalue("lm_run" if variant == "lm" else
                                  "edge_run")
    imgs, boot_state, jouts, _ = run
    cfg_kw = CFG_LM if variant == "lm" else CFG_EDGE
    assert len(jouts) >= 4
    cfg = SVOConfig(**cfg_kw)
    track = pipeline.make_track_frame(cfg, pcam, st.arena_dims(cfg, W, H))
    vo = st.state_from_numpy(boot_state, device=CPU)
    start = len(imgs) - len(jouts)
    n_kf = 0
    for k, jo in enumerate(jouts):
        vo, out = track(vo, torch.from_numpy(imgs[start + k]))
        res = int(out["result"])
        assert res == jo["result"], (k, res, jo["result"])
        n_kf += res == pipeline.RES_IS_KEYFRAME
        for key in ("n_matches", "n_edges"):
            a, b = int(out[key]), jo[key]
            assert abs(a - b) <= max(3, 0.03 * b), (k, key, a, b)
        dc = np.abs(out["t_wc"].numpy() - jo["t_wc"]).max()
        assert dc < 2e-3, (k, dc)
        ang = _quat_angle(out["T_cw"].q.numpy(), jo["q"])
        assert ang < 1e-3, (k, ang)
    assert n_kf >= 1, "the tracked frames must insert a keyframe"
    if variant == "edgelets_1d":
        seeds = vo.seeds
        assert int((seeds.valid & (seeds.ftype == detect.FTYPE_EDGELET))
                   .sum()) > 0, "no edgelet seeds spawned"


# ---------------------------------------------------------------------------
# map_tools and checkpoint, on a tracked state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracked(lm_run):
    """The JAX handler's state after the LM run, in both packages."""
    *_, handler = lm_run
    jvo = handler.vo
    vo = st.state_from_numpy(_jax_state_to_numpy(jvo), device=CPU)
    return jvo, vo, handler


@pytest.mark.parametrize("fn", ["transform_map", "get_close_keyframes",
                                "get_furthest_keyframe", "map_validation",
                                "map_statistics"])
def test_map_tools(tracked, pcam, fn):
    jvo, vo, handler = tracked
    if fn == "transform_map":
        Tj, Tp = _twist_pose([0.1, -0.2, 0.3, 0.2, -0.1, 0.4])
        s = 1.7
        oj = jax.jit(jmt.transform_map)(jvo, Tj.rotation_matrix(), Tj.t, s)
        op = map_tools.transform_map(vo, Tp.rotation_matrix(), Tp.t, s)
        a, b = st.state_to_numpy(op), _jax_state_to_numpy(oj)
        for k in ("points.pos", "kfs.q_kw", "kfs.t_kw", "kfs.scene_depth",
                  "last.q_fw", "last.t_fw", "seeds.mu", "seeds.sigma2",
                  "seeds.z_range"):
            close(a[k], b[k], atol=2e-4, rtol=1e-4)
        # camera-frame geometry scales by s (tests/test_map_viz.py)
        pv = vo.points.valid
        k = int(torch.nonzero(vo.kfs.valid)[0])
        T_old = SE3(q=vo.kfs.q_kw[k], t=vo.kfs.t_kw[k])
        T_new = SE3(q=op.kfs.q_kw[k], t=op.kfs.t_kw[k])
        close(T_new.apply(op.points.pos[pv]),
              s * T_old.apply(vo.points.pos[pv]), atol=2e-3, rtol=2e-3)
    elif fn == "get_close_keyframes":
        T_cw = jvo.last.T_fw
        dj = np.asarray(jax.jit(jmt.get_close_keyframes)(jvo, T_cw,
                                                         handler.cam))
        dp = map_tools.get_close_keyframes(vo, pse3(T_cw), pcam).numpy()
        np.testing.assert_array_equal(np.isfinite(dp), np.isfinite(dj))
        assert np.isfinite(dp).any()
        close(dp[np.isfinite(dp)], dj[np.isfinite(dj)], atol=1e-5)
    elif fn == "get_furthest_keyframe":
        for pos in (np.asarray(jvo.last.T_fw.inverse().t),
                    np.array([5.0, -3.0, 1.0], np.float32)):
            kj = int(jmt.get_furthest_keyframe(jvo, pos))
            kp = map_tools.get_furthest_keyframe(vo, t(pos))
            assert kp.dtype == torch.int32 and int(kp) == kj
            assert bool(vo.kfs.valid[kj])
        empty = vo.replace(kfs=vo.kfs.replace(
            valid=torch.zeros_like(vo.kfs.valid)))
        assert int(map_tools.get_furthest_keyframe(empty, t(pos))) == -1
    elif fn == "map_validation":
        ej = jmt.map_validation(jvo, handler.dims)
        ep = map_tools.map_validation(vo, handler.dims)
        assert ep == ej and all(v == 0 for v in ep.values()), ep
        # a valid feature pointed at a deleted landmark is caught
        k = int(torch.nonzero(vo.kfs.valid)[0])
        c = int(torch.nonzero(vo.kfs.ftr_valid[k])[0])
        dead = int(torch.nonzero(vo.points.ptype == st.TYPE_DELETED)[0])
        fp = vo.kfs.ftr_point.clone()
        fp[k, c] = dead
        bad = vo.replace(kfs=vo.kfs.replace(ftr_point=fp))
        bad_j = jvo.replace(kfs=jvo.kfs.replace(
            ftr_point=jvo.kfs.ftr_point.at[k, c].set(dead)))
        ep = map_tools.map_validation(bad, handler.dims)
        assert ep == jmt.map_validation(bad_j, handler.dims)
        assert ep["ftr_to_deleted_point"] >= 1
    else:
        sp = map_tools.map_statistics(vo)
        assert sp == jmt.map_statistics(jvo)
        assert sp["n_keyframes"] >= 2 and sp["n_points"] > 0


def _small_states():
    """The same non-trivial small state in both packages."""
    kw = dict(max_n_kfs=2, max_points=64, max_seeds=64)
    jvo = jst.init_state(JConfig(**kw), 64, 48)
    d = _jax_state_to_numpy(jvo)
    rng = np.random.default_rng(26)
    for k, v in d.items():
        if v.dtype == np.float32:
            d[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif v.dtype == np.int32:
            d[k] = rng.integers(-1, 50, v.shape).astype(np.int32)
        else:
            d[k] = rng.random(v.shape) < 0.5
    subs = {"kfs": jst.KeyframeArena, "points": jst.PointArena,
            "seeds": jst.SeedArena, "last": jst.FrameState}
    parts = {n: c(**{f.name: jnp.asarray(d[f"{n}.{f.name}"])
                     for f in dataclasses.fields(c)}) for n, c in subs.items()}
    rest = {f.name: jnp.asarray(d[f.name])
            for f in dataclasses.fields(jst.VOState) if f.name not in subs}
    jfull = jst.VOState(**parts, **rest)
    return (jfull, st.state_from_numpy(d, device=CPU), d,
            st.init_state(SVOConfig(**kw), 64, 48, device=CPU), jvo)


def _assert_state_equal(d, ref):
    assert list(d) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(d[k], ref[k], err_msg=k)
        assert d[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint(tmp_path, writer, reader):
    """A checkpoint round trip, and a checkpoint written by one package
    read by the other (the same arrays.npz and meta.json)."""
    jfull, pfull, d, p_like, j_like = _small_states()
    path = str(tmp_path / "ckpt")
    extra = {"stage": 3, "n_fail": 1}
    if writer == "port":
        checkpoint.save_state(path, pfull, extra=extra)
    else:
        jckpt.save_state(path, jfull, extra=extra)
    if reader == "port":
        vo, ex = checkpoint.load_state(path, p_like)
        _assert_state_equal(st.state_to_numpy(vo), d)
    else:
        vo, ex = jckpt.load_state(path, j_like)
        _assert_state_equal(_jax_state_to_numpy(vo), d)
    assert ex == extra
    if writer == reader == "port":
        # the handler's stage machine rides along
        class H:
            pass
        h = H()
        h.vo, h.stage, h._n_fail = pfull, 3, 2
        checkpoint.save_handler(path, h)
        h2 = H()
        h2.vo, h2.stage, h2._n_fail = p_like, 0, 0
        checkpoint.load_handler(path, h2)
        assert (h2.stage, h2._n_fail) == (3, 2)
        _assert_state_equal(st.state_to_numpy(h2.vo), d)
        # a state of another configuration does not load
        other = st.init_state(SVOConfig(max_n_kfs=3, max_points=64,
                                        max_seeds=64), 64, 48, device=CPU)
        with pytest.raises(ValueError, match="kfs.stack"):
            checkpoint.load_state(path, other)
