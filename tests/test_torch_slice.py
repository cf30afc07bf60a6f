"""The PyTorch port's slices as a whole, held against the JAX package on
the CPU: (a) from one JAX-built post-bootstrap state both `track_frame`s run
the next frames; (b) `bootstrap_pair` with the JAX package's RANSAC draws;
(c) the port's own FrameHandler reaches DEFAULT, inserts a keyframe and
never fails; (d) with local BA on (the default `loba_n_iter=5`) both
FrameHandlers track the same frames from one JAX-built state, with the same
per-frame trace records; (e) `relocalize_frame_at_pose` on one JAX-built
state; (f) `make_track_scan` against JAX's scan.

Frames are rendered by the JAX package's synthetic renderer at 320x240 (the
size tests/test_pipeline.py tracks at) and handed to the port as numpy.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.core import frame_handler as jfh
from android_svo_tpu.core import initialization as jinit
from android_svo_tpu.core import pipeline as jpipe
from android_svo_tpu.core import state as jst
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.ops import detect as jdetect
from android_svo_tpu.geometry.se3 import SE3 as JSE3
from android_svo_tpu.ops import pyramid as jpyr
from android_svo_tpu.utils.profiling import PerformanceMonitor as JPM

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import initialization as init
from android_svo_tpu_torch.core import pipeline
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import pyramid
from android_svo_tpu_torch.utils.profiling import PerformanceMonitor

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

W, H = 320, 240
CFG_KW = dict(max_n_kfs=8, max_points=2048, max_seeds=1024,
              ransac_n_trials=128, img_align_n_iter=15,
              init_min_disparity=20.0, loba_n_iter=0)
CFG_BA = dict(CFG_KW, loba_n_iter=5)      # the default local BA
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


def numpy_to_jax_state(d: dict):
    """A JAX VOState from the flat numpy dict (inverse of
    `jax_state_to_numpy`)."""
    subs = {"kfs": jst.KeyframeArena, "points": jst.PointArena,
            "seeds": jst.SeedArena, "last": jst.FrameState}
    parts = {name: cls(**{f.name: jnp.asarray(d[f"{name}.{f.name}"])
                          for f in dataclasses.fields(cls)})
             for name, cls in subs.items()}
    rest = {f.name: jnp.asarray(d[f.name])
            for f in dataclasses.fields(jst.VOState) if f.name not in subs}
    return jst.VOState(**parts, **rest)


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


@pytest.fixture(scope="module")
def jax_run_ba(seq, tmp_path_factory):
    """The JAX FrameHandler at the default local BA over the sequence, with
    a trace monitor; keeps the post-bootstrap state, the tracked frames'
    outputs and trace records, and the handler."""
    cam, imgs, _ = seq
    trace = tmp_path_factory.mktemp("jax_trace") / "trace.jsonl"
    pm = JPM(trace_path=str(trace))
    handler = jfh.FrameHandler(cam, JConfig(**CFG_BA), perf_mon=pm)
    boot_state, outs, n_boot = None, [], 0
    for i, img in enumerate(imgs):
        was_default = handler.stage == jfh.STAGE_DEFAULT_FRAME
        res = handler.add_image(jnp.asarray(img))
        if not was_default and handler.stage == jfh.STAGE_DEFAULT_FRAME:
            boot_state, n_boot = jax_state_to_numpy(handler.vo), i + 1
        elif was_default:
            outs.append({"result": res.result, "n_matches": res.n_matches,
                         "n_edges": res.n_edges,
                         "q": np.asarray(res.T_cw.q),
                         "t_wc": np.asarray(res.t_wc)})
    pm.close()
    assert boot_state is not None, "JAX handler did not bootstrap"
    records = [json.loads(x) for x in trace.read_text().splitlines()]
    return boot_state, outs, records[n_boot:], handler


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


class TestDefaultConfig:
    """(d)-(f): local BA on, relocalization at a given keyframe, and the
    whole-sequence scan, each from one JAX-built state."""

    def test_tracks_like_jax_with_local_ba(self, seq, jax_run_ba, tmp_path):
        _, imgs, _ = seq
        boot_state, jouts, jrecords, _ = jax_run_ba
        assert pipeline.RES_IS_KEYFRAME in [o["result"] for o in jouts]
        pm = PerformanceMonitor(trace_path=str(tmp_path / "trace.jsonl"))
        handler = fh.FrameHandler(port_camera(), SVOConfig(**CFG_BA),
                                  perf_mon=pm, device="cpu")
        handler.vo = st.state_from_numpy(boot_state, device=CPU)
        handler.stage = fh.STAGE_DEFAULT_FRAME
        start = len(imgs) - len(jouts)
        for k, jo in enumerate(jouts):
            res = handler.add_image(torch.from_numpy(imgs[start + k]))
            assert res.result == jo["result"], (k, res.result, jo["result"])
            for key in ("n_matches", "n_edges"):
                a, b = getattr(res, key), jo[key]
                assert abs(a - b) <= max(3, 0.03 * b), (k, key, a, b)
            # slice 1's tolerances hold with BA in the loop
            dc = np.abs(res.t_wc.numpy() - jo["t_wc"]).max()
            assert dc < 2e-3, (k, dc)
            ang = _quat_angle(res.T_cw.q.numpy(), jo["q"])
            assert ang < 1e-3, (k, ang)
        pm.close()
        assert handler.n_local_ba >= 1
        # the trace: one record per frame with the JAX monitor's keys and
        # the same frame ids, stages and results
        recs = [json.loads(x)
                for x in (tmp_path / "trace.jsonl").read_text().splitlines()]
        assert len(recs) == len(jrecords) == len(jouts)
        for a, b in zip(recs, jrecords):
            assert list(a) == list(b)
            for key in ("frame_id", "stage", "result"):
                assert a[key] == b[key], key

    def test_relocalize_frame_at_pose_matches_jax(self, jax_run_ba):
        """tests/test_map_viz.py's hook test on one state in both packages:
        seat the tracker on the newest keyframe and feed that keyframe's
        own image back; both recover its pose."""
        *_, jhandler = jax_run_ba
        jvo = jhandler.vo
        k = int(np.argmax(np.asarray(jvo.kfs.frame_id)
                          * np.asarray(jvo.kfs.valid)))
        kf_id = int(jvo.kfs.frame_id[k])
        img = np.asarray(jvo.kfs.stack[k, 0, :H, :W])
        T_kw = JSE3(q=jvo.kfs.q_kw[k], t=jvo.kfs.t_kw[k])
        jh = copy.copy(jhandler)
        jres = jh.relocalize_frame_at_pose(kf_id, T_kw, jnp.asarray(img))
        handler = fh.FrameHandler(port_camera(), SVOConfig(**CFG_BA),
                                  device="cpu")
        handler.vo = st.state_from_numpy(jax_state_to_numpy(jvo), device=CPU)
        handler.stage = fh.STAGE_DEFAULT_FRAME
        pT = SE3(q=torch.from_numpy(np.array(T_kw.q)),
                 t=torch.from_numpy(np.array(T_kw.t)))
        res = handler.relocalize_frame_at_pose(kf_id, pT,
                                               torch.from_numpy(img))
        assert res.result == jres.result != pipeline.RES_FAILURE
        assert handler.stage == fh.STAGE_DEFAULT_FRAME
        err = float(torch.linalg.norm(res.T_cw.inverse().t
                                      - pT.inverse().t))
        assert err < 0.01, err
        dc = np.abs(res.t_wc.numpy() - np.asarray(jres.t_wc)).max()
        assert dc < 2e-3, dc
        unknown = handler.relocalize_frame_at_pose(
            99999, pT, torch.zeros((H, W)))
        assert unknown.result == pipeline.RES_FAILURE

    def test_track_scan_matches_jax(self, seq, jax_run):
        """Both packages' make_track_scan over the tracked frames from the
        JAX post-bootstrap state (local BA is outside the scan in both)."""
        cam, imgs, _ = seq
        boot_state, jouts = jax_run
        start = len(imgs) - len(jouts)
        jscan = jax.jit(jpipe.make_track_scan(
            JConfig(**CFG_KW), cam, jst.arena_dims(JConfig(**CFG_KW), W, H)))
        _, jo = jscan(numpy_to_jax_state(boot_state),
                      jnp.asarray(np.stack(imgs[start:])))
        cfg = SVOConfig(**CFG_KW)
        scan = pipeline.make_track_scan(cfg, port_camera(),
                                        st.arena_dims(cfg, W, H))
        _, po = scan(st.state_from_numpy(boot_state, device=CPU),
                     torch.from_numpy(np.stack(imgs[start:])))
        assert po["t_wc"].shape == (len(jouts), 3)
        np.testing.assert_array_equal(po["result"].numpy(),
                                      np.asarray(jo["result"]))
        np.testing.assert_array_equal(po["result"].numpy(),
                                      [o["result"] for o in jouts])
        for key in ("n_matches", "n_edges"):
            a, b = po[key].numpy(), np.asarray(jo[key])
            assert (np.abs(a - b) <= np.maximum(3, 0.03 * b)).all(), key
        assert np.abs(po["t_wc"].numpy() - np.asarray(jo["t_wc"])).max() \
            < 2e-3
