"""The port's core steps — update_seeds, reproject_map, optimize_pose,
optimize_points, insert_keyframe — each run from one JAX-built state
(bootstrap + two tracked frames of the JAX FrameHandler at 320x240),
converted with `state_from_numpy`, against the JAX function on the same
state and inputs.

Counts must agree within the stated tolerance (a borderline ICLK
convergence can flip under fp32 reassociation); arrays within fp32
tolerances on the rows both sides keep.
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
from android_svo_tpu.core import pipeline as jpipe
from android_svo_tpu.core import point_opt as jpo
from android_svo_tpu.core import pose_opt as jpose
from android_svo_tpu.core import reprojector as jrep
from android_svo_tpu.core import state as jst
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.geometry.se3 import SE3 as JSE3
from android_svo_tpu.ops import pyramid as jpyr

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import pipeline, point_opt, pose_opt
from android_svo_tpu_torch.core import reprojector
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import pyramid

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

W, H = 320, 240
CFG_KW = dict(max_n_kfs=8, max_points=2048, max_seeds=1024,
              ransac_n_trials=128, img_align_n_iter=15,
              init_min_disparity=20.0, loba_n_iter=0)
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


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
def world():
    """JAX state after bootstrap + 2 tracked frames, the next frame's image
    and the pose the JAX handler tracked it at."""
    jcam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(11), 2048)
    step = 0.05
    imgs = [np.asarray(jsyn.render(tex, jcam, jsyn.lookdown_pose(
        step * i, 0.3 * step * i, -3.0,
        (0.45 + 0.002 * i, -0.002 * i, 0.004 * i)))) for i in range(8)]
    handler = jfh.FrameHandler(jcam, JConfig(**CFG_KW))
    for img in imgs[:7]:
        handler.add_image(jnp.asarray(img))
    assert handler.stage == jfh.STAGE_DEFAULT_FRAME
    state = handler.vo
    res = handler.add_image(jnp.asarray(imgs[7]))
    return dict(jcam=jcam, jvo=state, img=imgs[7],
                q=np.asarray(res.T_cw.q), tt=np.asarray(res.T_cw.t),
                np_state=jax_state_to_numpy(state))


@pytest.fixture(scope="module")
def port(world):
    cfg = SVOConfig(**CFG_KW)
    cam = synthetic.default_camera(W, H, device=CPU)
    vo = st.state_from_numpy(world["np_state"], device=CPU)
    dims = st.arena_dims(cfg, W, H)
    pyr = pyramid.build_pyramid(t(world["img"]), cfg.total_pyr_levels)
    return dict(cfg=cfg, cam=cam, vo=vo, dims=dims, pyr=pyr,
                stack=pyramid.stack_from_pyramid(pyr),
                T=SE3(q=t(world["q"]), t=t(world["tt"])))


@pytest.fixture(scope="module")
def jax_side(world):
    jcfg = JConfig(**CFG_KW)
    dims = jst.arena_dims(jcfg, W, H)
    pyr = jpyr.build_pyramid(jnp.asarray(world["img"]),
                             jcfg.total_pyr_levels)
    return dict(cfg=jcfg, dims=dims, pyr=pyr,
                stack=jpyr.stack_from_pyramid(pyr),
                T=JSE3(q=jnp.asarray(world["q"]), t=jnp.asarray(world["tt"])))


def close(a, b, atol=1e-4, rtol=1e-4):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


def test_state_roundtrip_from_jax(world):
    vo = st.state_from_numpy(world["np_state"], device=CPU)
    back = st.state_to_numpy(vo)
    assert set(back) == set(world["np_state"])
    for k, v in world["np_state"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k


@pytest.fixture(scope="module")
def reproj(world, port, jax_side):
    j = jax_side
    fj = jax.jit(partial(jrep.reproject_map, cam=world["jcam"], cfg=j["cfg"],
                         dims=j["dims"]))
    feats_j, pts_j, n_j = fj(world["jvo"], j["stack"], T_cw=j["T"])
    p = port
    feats_p, pts_p, n_p = reprojector.reproject_map(
        p["vo"], p["stack"], p["T"], p["cam"], p["cfg"], p["dims"])
    return feats_j, pts_j, int(n_j), feats_p, pts_p, int(n_p)


def test_reproject_map(reproj):
    feats_j, pts_j, n_j, feats_p, pts_p, n_p = reproj
    # matches: +-3 or 3% (borderline window-ICLK convergence flips)
    assert abs(n_p - n_j) <= max(3, 0.03 * n_j), (n_p, n_j)
    vj = np.asarray(feats_j["valid"])
    vp = feats_p["valid"].numpy()
    assert (vj != vp).sum() <= max(3, 0.03 * n_j)
    both = vj & vp
    np.testing.assert_array_equal(feats_p["point"].numpy()[both],
                                  np.asarray(feats_j["point"])[both])
    close(feats_p["px"].numpy()[both], np.asarray(feats_j["px"])[both],
          atol=2e-2)
    # the warp cache refresh is deterministic arithmetic: same slots, same
    # patches
    np.testing.assert_array_equal(pts_p.warp_frame.numpy(),
                                  np.asarray(pts_j.warp_frame))
    close(pts_p.warp_patch, pts_j.warp_patch, atol=2e-2)
    # quality counters: the flipped matches change at most that many
    dn = np.abs(pts_p.n_succ.numpy() - np.asarray(pts_j.n_succ)).sum()
    assert dn <= max(3, 0.03 * n_j)


def test_optimize_pose(world, reproj, port, jax_side):
    feats_j = reproj[0]
    jvo = world["jvo"]
    cfg_j = jax_side["cfg"]
    pw = np.asarray(jvo.points.pos)[np.maximum(np.asarray(feats_j["point"]),
                                               0)]
    args = (pw, np.asarray(feats_j["f"]), np.asarray(feats_j["level"]),
            np.asarray(feats_j["valid"]))
    rj = jax.jit(partial(jpose.optimize_pose, cfg=cfg_j))(
        jax_side["T"], *args, focal=world["jcam"].fx)
    rp = pose_opt.optimize_pose(port["T"], *[t(a) for a in args],
                                port["cam"].fx, port["cfg"])
    close(rp[0].q, rj[0].q, atol=1e-5)
    close(rp[0].t, rj[0].t, atol=1e-5)
    # inlier flags: at most 1 flip at the 2 px threshold
    assert (rp[1].numpy() != np.asarray(rj[1])).sum() <= 1
    assert abs(int(rp[2]) - int(rj[2])) <= 1
    close(rp[3], rj[3], rtol=1e-3, atol=1e-9)


def test_optimize_points(world, port):
    jvo = world["jvo"]
    pts = jvo.points
    valid = np.asarray(pts.valid) & (np.asarray(pts.obs_count) >= 2)
    slots_j, sel_j = jpo.select_points_for_optim(pts.last_optim,
                                                 jnp.asarray(valid), 20)
    slots_p, sel_p = point_opt.select_points_for_optim(
        t(pts.last_optim), t(valid), 20)
    np.testing.assert_array_equal(slots_p.numpy(), np.asarray(slots_j))
    slots = np.asarray(slots_j)
    obs_kf = np.asarray(pts.obs_kf)[slots]
    ks = np.maximum(obs_kf, 0)
    obs_ok = (obs_kf >= 0) & np.asarray(jvo.kfs.valid)[ks]
    args = (np.asarray(pts.pos)[slots], np.asarray(jvo.kfs.q_kw)[ks],
            np.asarray(jvo.kfs.t_kw)[ks], np.asarray(pts.obs_f)[slots],
            obs_ok, np.asarray(sel_j))
    pj, cj = jpo.optimize_points(*args, 5)
    pp_, cp = point_opt.optimize_points(*[t(a) for a in args], 5)
    close(pp_, pj, atol=1e-4)
    close(cp, cj, rtol=1e-3, atol=1e-9)


def test_update_seeds(world, port, jax_side):
    j = jax_side
    fj = jax.jit(partial(jpipe.update_seeds, cam=world["jcam"],
                         cfg=j["cfg"]))
    vj = fj(world["jvo"], j["stack"], T_cw=j["T"])
    vp = pipeline.update_seeds(port["vo"], port["stack"], port["T"],
                               port["cam"], port["cfg"])
    sj, sp = vj.seeds, vp.seeds
    np.testing.assert_array_equal(sp.patch_frame.numpy(),
                                  np.asarray(sj.patch_frame))
    # live seeds: equal up to the few whose epipolar match flips
    vjm, vpm = np.asarray(sj.valid), sp.valid.numpy()
    assert (vjm != vpm).sum() <= 3
    both = vjm & vpm
    upd = np.abs(sp.mu.numpy() - np.asarray(sj.mu)) > 1e-3 * np.abs(
        np.asarray(sj.mu))
    # seeds whose measurement differs (a flipped match): at most 3% of live
    assert (upd & both).sum() <= max(3, 0.03 * both.sum()), (
        (upd & both).sum(), both.sum())
    same = both & ~upd
    close(sp.sigma2.numpy()[same], np.asarray(sj.sigma2)[same], rtol=1e-3)
    close(sp.a.numpy()[same], np.asarray(sj.a)[same], rtol=1e-3)
    close(sp.b.numpy()[same], np.asarray(sj.b)[same], rtol=1e-3)
    assert abs(int(vp.points.valid.sum()) - int(vj.points.valid.sum())) <= 3


def test_insert_keyframe(world, reproj, port, jax_side):
    feats_j = reproj[0]
    j = jax_side
    fj = jax.jit(partial(jpipe.insert_keyframe, cam=world["jcam"],
                         cfg=j["cfg"], dims=j["dims"]))
    vj = fj(world["jvo"], j["pyr"], j["stack"], j["T"], feats_j)
    feats_p = {k: t(v) for k, v in feats_j.items()}
    vp = pipeline.insert_keyframe(port["vo"], port["pyr"], port["stack"],
                                  port["T"], feats_p, port["cam"],
                                  port["cfg"], port["dims"])
    kj, kp = vj.kfs, vp.kfs
    for name in ("valid", "frame_id", "ftr_point", "ftr_valid",
                 "ftr_level"):
        np.testing.assert_array_equal(getattr(kp, name).numpy(),
                                      np.asarray(getattr(kj, name)), name)
    close(kp.stack, kj.stack, atol=1e-3)
    close(kp.scene_depth, kj.scene_depth, atol=1e-5)
    assert int(vp.kf_batch) == int(vj.kf_batch)
    # observation bookkeeping (point 0's row is checked separately below)
    pj, pp_ = vj.points, vp.points
    rows = slice(1, None)
    for name in ("obs_kf", "obs_count", "ptype", "obs_level"):
        np.testing.assert_array_equal(
            getattr(pp_, name).numpy()[rows],
            np.asarray(getattr(pj, name))[rows], name)
    # new seeds: the detected corners can differ in a few near-tie cells
    # (score-map box sums round differently), so counts within 3%
    nj = int(vj.seeds.valid.sum())
    npp = int(vp.seeds.valid.sum())
    assert abs(npp - nj) <= max(3, 0.03 * nj), (npp, nj)


def test_point0_observation_is_kept(world, port, jax_side):
    """JAX's insert_keyframe writes the old observation back at point 0 for
    every feature row that is not ok (`pid = 0`, pipeline.py:290-308); when
    point 0 itself is observed, those duplicate writes race its new record.
    The port drops the rows that are not ok, so point 0's observation is
    recorded deterministically (ROADMAP Queue 3)."""
    C = port["dims"]["C"]
    feats = {
        "px": np.full((C, 2), 50.0, np.float32),
        "f": np.tile(np.array([0.0, 0.0, 1.0], np.float32), (C, 1)),
        "level": np.zeros(C, np.int32),
        "point": np.full(C, -1, np.int32),
        "valid": np.zeros(C, bool),
    }
    feats["point"][3] = 0          # point 0 observed in cell 3 ...
    feats["valid"][3] = True       # ... and every later cell not ok
    vp = pipeline.insert_keyframe(port["vo"], port["pyr"], port["stack"],
                                  port["T"], {k: t(v) for k, v in
                                              feats.items()},
                                  port["cam"], port["cfg"], port["dims"])
    n0 = int(port["vo"].points.obs_count[0])
    slot = int(pipeline.select_kf_slot(port["vo"], port["T"]))
    assert int(vp.points.obs_count[0]) == n0 + 1
    o = min(n0, vp.points.obs_kf.shape[1] - 1)
    assert int(vp.points.obs_kf[0, o]) == slot
    # the JAX package on the same input records the count but (on the CPU
    # backend's in-order scatter) keeps the stale table entry
    j = jax_side
    vj = jax.jit(partial(jpipe.insert_keyframe, cam=world["jcam"],
                         cfg=j["cfg"], dims=j["dims"]))(
        world["jvo"], j["pyr"], j["stack"], j["T"],
        {k: jnp.asarray(v) for k, v in feats.items()})
    assert int(vj.points.obs_count[0]) == n0 + 1
    assert int(vj.points.obs_kf[0, o]) != slot


def test_seed0_retired_on_promotion(world, port):
    """JAX retires promoted seeds with `.at[src].set(take)` where the rows
    that do not take also point at seed 0 (pipeline.py:210-212); on the CPU
    backend's in-order scatter a later `False` overwrites seed 0's `True`,
    so a converged seed 0 stays live after its promotion.  The port writes
    only the rows that take (ROADMAP Queue 3)."""
    d = dict(world["np_state"])
    valid = d["seeds.valid"].copy()
    valid[0] = True
    d["seeds.valid"] = valid
    conv = np.zeros_like(valid)
    conv[0] = True                              # seed 0 converged
    jvo = world["jvo"].replace(seeds=world["jvo"].seeds.replace(
        valid=jnp.asarray(valid)))
    vj = jpipe.promote_converged_seeds(jvo, jnp.asarray(conv),
                                       world["jcam"], JConfig(**CFG_KW))
    vp = pipeline.promote_converged_seeds(
        st.state_from_numpy(d, device=CPU), t(conv), port["cam"],
        port["cfg"])
    # both promote it into the same landmark slot ...
    np.testing.assert_array_equal(vp.points.ptype.numpy(),
                                  np.asarray(vj.points.ptype))
    close(vp.points.pos, vj.points.pos, atol=1e-5)
    # ... but only the port retires the seed
    assert not bool(vp.seeds.valid[0])
    assert bool(vj.seeds.valid[0])
    np.testing.assert_array_equal(vp.seeds.valid.numpy()[1:],
                                  np.asarray(vj.seeds.valid)[1:])
