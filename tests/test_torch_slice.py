"""The PyTorch port's slice as a whole, held against the JAX package on the
CPU: (a) from one JAX-built post-bootstrap state both `track_frame`s run the
next frames; (b) `bootstrap_pair` with the JAX package's RANSAC draws;
(c) the port's own FrameHandler reaches DEFAULT, inserts a keyframe and
never fails.

Frames are rendered by the JAX package's synthetic renderer at 320x240 (the
size tests/test_pipeline.py tracks at) and handed to the port as numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.core import frame_handler as jfh
from android_svo_tpu.core import initialization as jinit
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.ops import detect as jdetect
from android_svo_tpu.ops import pyramid as jpyr

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import initialization as init
from android_svo_tpu_torch.core import pipeline
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.ops import pyramid

W, H = 320, 240
CFG_KW = dict(max_n_kfs=8, max_points=2048, max_seeds=1024,
              ransac_n_trials=128, img_align_n_iter=15,
              init_min_disparity=20.0, loba_n_iter=0)
N_FRAMES = 11          # bootstrap lands on frame 4; frames 5..10 tracked
CPU = torch.device("cpu")


def _poses(n, step=0.05):
    return [jsyn.lookdown_pose(step * i, 0.3 * step * i, -3.0,
                               (0.45 + 0.002 * i, -0.002 * i, 0.004 * i))
            for i in range(n)]


@pytest.fixture(scope="module")
def seq():
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(11), 2048)
    poses = _poses(N_FRAMES)
    imgs = [np.array(jsyn.render(tex, cam, p)) for p in poses]
    return cam, imgs, poses


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


def port_camera():
    return synthetic.default_camera(W, H, device=CPU)


@pytest.fixture(scope="module")
def jax_run(seq):
    """JAX FrameHandler over the sequence; keeps the state right after the
    bootstrap and every tracked frame's outputs."""
    cam, imgs, _ = seq
    handler = jfh.FrameHandler(cam, JConfig(**CFG_KW))
    boot_state, outs = None, []
    for img in imgs:
        was_default = handler.stage == jfh.STAGE_DEFAULT_FRAME
        res = handler.add_image(jnp.asarray(img))
        if not was_default and handler.stage == jfh.STAGE_DEFAULT_FRAME:
            boot_state = jax_state_to_numpy(handler.vo)
        elif was_default:
            outs.append({"result": res.result, "n_matches": res.n_matches,
                         "n_edges": res.n_edges,
                         "q": np.asarray(res.T_cw.q),
                         "t_wc": np.asarray(res.t_wc)})
    assert boot_state is not None, "JAX handler did not bootstrap"
    return boot_state, outs


def _quat_angle(q1, q2):
    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return 2.0 * np.arccos(min(d, 1.0))


class TestTrackFromJaxState:
    """(a) Both track_frames from one JAX-built post-bootstrap state."""

    def test_track_frames_agree(self, seq, jax_run):
        _, imgs, _ = seq
        boot_state, jouts = jax_run
        assert len(jouts) >= 4
        cfg = SVOConfig(**CFG_KW)
        cam = port_camera()
        dims = st.arena_dims(cfg, W, H)
        track = pipeline.make_track_frame(cfg, cam, dims)
        vo = st.state_from_numpy(boot_state, device=CPU)
        start = len(imgs) - len(jouts)
        n_kf = 0
        for k, jo in enumerate(jouts):
            vo, out = track(vo, torch.from_numpy(imgs[start + k]))
            res = int(out["result"])
            # per-frame result codes must be equal
            assert res == jo["result"], (k, res, jo["result"])
            n_kf += res == pipeline.RES_IS_KEYFRAME
            # match / edge counts: +-3 or 3%, whichever is larger (fp32
            # reassociation flips a few borderline ICLK convergences)
            for key in ("n_matches", "n_edges"):
                a, b = int(out[key]), jo[key]
                assert abs(a - b) <= max(3, 0.03 * b), (k, key, a, b)
            # camera centres within 2e-3, rotations within 1e-3 rad
            dc = np.abs(out["t_wc"].numpy() - jo["t_wc"]).max()
            assert dc < 2e-3, (k, dc)
            ang = _quat_angle(out["T_cw"].q.numpy(), jo["q"])
            assert ang < 1e-3, (k, ang)
        assert n_kf >= 1, "the tracked frames must insert a keyframe"


class TestBootstrapPair:
    """(b) bootstrap_pair with the JAX package's RANSAC draws."""

    def test_bootstrap_matches_jax(self, seq):
        _, imgs, _ = seq
        jcfg = JConfig(**CFG_KW)
        cfg = SVOConfig(**CFG_KW)
        jcam = jsyn.default_camera(W, H)
        pyr0 = jpyr.build_pyramid(jnp.asarray(imgs[0]), jcfg.total_pyr_levels)
        pyr1 = jpyr.build_pyramid(jnp.asarray(imgs[4]), jcfg.total_pyr_levels)
        det = jdetect.detect_features(pyr0[:jcfg.n_pyr_levels], None, jcfg)
        key = jax.random.PRNGKey(5)
        jb = jinit.bootstrap_pair(pyr0, pyr1, jcam, det["px"], det["valid"],
                                  jcfg, key)
        # the draws bootstrap_pair makes from `key`
        ke, kh = jax.random.split(key)
        C = det["px"].shape[0]
        de = np.asarray(jax.random.uniform(ke, (jcfg.ransac_n_trials, C),
                                           jnp.float32))
        dh = np.asarray(jax.random.uniform(kh, (jcfg.ransac_n_trials, C),
                                           jnp.float32))
        tp = pyramid.build_pyramid(torch.from_numpy(imgs[0]),
                                   cfg.total_pyr_levels)
        tc = pyramid.build_pyramid(torch.from_numpy(imgs[4]),
                                   cfg.total_pyr_levels)
        pb = init.bootstrap_pair(
            tp, tc, port_camera(), torch.from_numpy(np.asarray(det["px"])),
            torch.from_numpy(np.asarray(det["valid"])), cfg,
            torch.from_numpy(de), torch.from_numpy(dh))
        tracked_j = np.asarray(jb["tracked"])
        tracked_p = pb["tracked"].numpy()
        # KLT tracked sets: at most 1% of features differ (borderline
        # convergence flips under fp32 reassociation)
        assert (tracked_j != tracked_p).sum() <= max(1, 0.01 * C)
        inl_j = np.asarray(jb["inlier"])
        inl_p = pb["inlier"].numpy()
        # inlier sets: at most 2% of correspondences differ
        assert (inl_j != inl_p).sum() <= max(2, 0.02 * inl_j.sum()), (
            (inl_j != inl_p).sum(), inl_j.sum())
        # pose within 1e-4 (quaternion and scaled translation)
        np.testing.assert_allclose(pb["T_cur_ref"].q.numpy(),
                                   np.asarray(jb["T_cur_ref"].q), atol=1e-4)
        np.testing.assert_allclose(pb["T_cur_ref"].t.numpy(),
                                   np.asarray(jb["T_cur_ref"].t), atol=1e-4)
        np.testing.assert_allclose(float(pb["disparity"]),
                                   float(jb["disparity"]), atol=1e-3)


class TestPortFrameHandler:
    """(c) The port's own FrameHandler on the CPU, same frames."""

    @pytest.mark.parametrize("align_mxu", [True, False])
    def test_reaches_default_with_keyframe(self, seq, align_mxu):
        """Both feature-align schedules: the window ICLK (default) and the
        per-iteration ICLK with the ZMSSD gate on a separate sample."""
        from android_svo_tpu_torch.evals.trajectory import ate_rmse
        _, imgs, poses = seq
        handler = fh.FrameHandler(
            port_camera(), SVOConfig(**CFG_KW, align_mxu=align_mxu),
            device="cpu")
        n_fail = n_kf = 0
        est, gt = [], []
        for i, img in enumerate(imgs):
            was_default = handler.stage == fh.STAGE_DEFAULT_FRAME
            res = handler.add_image(torch.from_numpy(img))
            if was_default:
                n_fail += res.result == pipeline.RES_FAILURE
                n_kf += res.result == pipeline.RES_IS_KEYFRAME
            if handler.stage == fh.STAGE_DEFAULT_FRAME:
                est.append(res.t_wc.numpy())
                gt.append(np.asarray(poses[i].t))
        assert handler.stage == fh.STAGE_DEFAULT_FRAME
        assert n_fail == 0
        assert n_kf >= 1
        # same accuracy bar as tests/test_pipeline.py's tracked sweep
        assert ate_rmse(np.array(est), np.array(gt)) < 0.09

    def test_relocalizes_after_occlusion(self):
        """Blank frames fail tracking into RELOCALIZING; when texture comes
        back near the last pose the handler seats the last frame on the
        closest keyframe and returns to DEFAULT (the scenario of
        tests/test_pipeline.py's occlusion test, shortened)."""
        from android_svo_tpu_torch.evals.trajectory import ate_rmse
        cam = jsyn.default_camera(W, H)
        tex = jsyn.make_texture(jax.random.PRNGKey(11), 2048)
        poses = _poses(18, step=0.03)
        occluded = set(range(10, 13))
        handler = fh.FrameHandler(port_camera(), SVOConfig(**CFG_KW),
                                  device="cpu")
        saw_reloc, recovered = False, False
        est, gt = [], []
        for i, pose in enumerate(poses):
            img = (np.zeros((H, W), np.float32) if i in occluded
                   else np.array(jsyn.render(tex, cam, pose)))
            res = handler.add_image(torch.from_numpy(img))
            saw_reloc |= handler.stage == fh.STAGE_RELOCALIZING
            recovered |= saw_reloc and handler.stage == fh.STAGE_DEFAULT_FRAME
            if (handler.stage == fh.STAGE_DEFAULT_FRAME and i not in occluded
                    and res.result != pipeline.RES_FAILURE):
                est.append(res.t_wc.numpy())
                gt.append(np.asarray(pose.t))
        assert saw_reloc, "the occlusion must trip the failure path"
        assert recovered, "the tracker never recovered"
        assert handler.stage == fh.STAGE_DEFAULT_FRAME
        assert ate_rmse(np.array(est), np.array(gt)) < 0.12
