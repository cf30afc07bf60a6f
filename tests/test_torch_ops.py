"""The port's ops modules (interp, pyramid, feature_align, detect,
sparse_align, matcher) against their JAX twins on the CPU.

Images are rendered by the JAX package's synthetic renderer at 320x240 and
handed over as numpy; other inputs are numpy draws from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.geometry.se3 import SE3 as JSE3
from android_svo_tpu.ops import detect as jdet
from android_svo_tpu.ops import feature_align as jfa
from android_svo_tpu.ops import interp as jinterp
from android_svo_tpu.ops import matcher as jmatch
from android_svo_tpu.ops import pyramid as jpyr
from android_svo_tpu.ops import sparse_align as jsa

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import detect, feature_align, interp, matcher
from android_svo_tpu_torch.ops import pyramid, sparse_align

W, H = 320, 240
CFG_KW = dict(max_n_kfs=4, max_points=512, max_seeds=256)


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, atol=1e-4, rtol=1e-5):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def frames():
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(11), 1024)
    poses = [jsyn.lookdown_pose(0.03 * i, 0.01 * i, -3.0,
                                (0.45 + 0.002 * i, -0.002 * i, 0.0))
             for i in range(2)]
    imgs = [np.asarray(jsyn.render(tex, cam, p)) for p in poses]
    return cam, imgs, poses


@pytest.fixture(scope="module")
def pcam():
    return synthetic.default_camera(W, H, device="cpu")


class TestInterp:
    def test_bilinear_and_clamps(self, frames):
        img = frames[1][0]
        rng = np.random.default_rng(1)
        # interior, border and far-outside coordinates
        uv = np.concatenate([rng.random((64, 2)) * [W, H],
                             rng.random((16, 2)) * [W + 40, H + 40] - 20,
                             [[-1e6, 5.0], [5.0, 1e6], [W - 1.0, H - 1.0]]])
        uv = uv.astype(np.float32)
        close(interp.bilinear_sample(t(img), t(uv)),
              jinterp.bilinear_sample(img, uv), atol=1e-3)

    def test_stack_sample_and_level_index(self, frames):
        stk = np.asarray(jpyr.build_stack(frames[1][0], 3))
        rng = np.random.default_rng(2)
        uv = (rng.random((20, 5, 2)) * 100).astype(np.float32)
        idx = np.array([0, 1, 2, -1, 5] * 4, np.int32)   # JAX index rules
        close(interp.bilinear_sample_stack(t(stk), t(idx), t(uv)),
              jinterp.bilinear_sample_stack(jnp.asarray(stk),
                                            jnp.asarray(idx), uv), atol=1e-3)

    @pytest.mark.parametrize("half", [2, 4, 8])
    def test_offsets_and_extract(self, frames, half):
        close(interp.patch_offsets(half), jinterp.patch_offsets(half))
        img = frames[1][0]
        c = np.array([[40.3, 50.7], [100.0, 90.25]], np.float32)
        close(interp.extract_patches(t(img), t(c), half),
              jinterp.extract_patches(img, c, half), atol=1e-3)

    def test_in_bounds(self):
        uv = np.array([[4.9, 10], [5, 10], [309, 10], [310, 10], [20, 228]],
                      np.float32)
        close(interp.in_bounds(t(uv), H, W, 5.0),
              jinterp.in_bounds(uv, H, W, 5.0))


class TestPyramid:
    @pytest.mark.parametrize("hw", [(240, 320), (97, 130), (480, 640)])
    def test_stack_shape(self, hw):
        assert pyramid.stack_shape(*hw, 5) == jpyr.stack_shape(*hw, 5)

    def test_pyramid_and_stack(self, frames):
        img = frames[1][0][:, :-3]                       # odd width
        jp = jpyr.build_pyramid(img, 5)
        pp_ = pyramid.build_pyramid(t(img), 5)
        for a, b in zip(pp_, jp):
            close(a, b, atol=1e-3)
        close(pyramid.stack_from_pyramid(pp_), jpyr.stack_from_pyramid(jp),
              atol=1e-3)
        close(pyramid.half_sample(t(img)), jpyr.half_sample(img), atol=1e-3)


class TestFeatureAlign:
    def test_patch_gradients(self):
        pb = np.random.default_rng(3).random((5, 10, 10)).astype(np.float32)
        for a, b in zip(feature_align.patch_gradients(t(pb)),
                        jfa.patch_gradients(pb)):
            close(a, b)

    def test_align2d(self, frames):
        img = frames[1][0]
        rng = np.random.default_rng(4)
        uv = (20 + rng.random((32, 2)) * [W - 40, H - 40]).astype(np.float32)
        pb = jinterp.extract_patches(img, uv, 5)
        ref, gx, gy = jfa.patch_gradients(pb)
        init = (uv + rng.uniform(-1.5, 1.5, (32, 2))).astype(np.float32)
        valid = np.ones(32, bool)
        uj, cj, mj = jfa.align2d(jnp.asarray(img), ref, gx, gy, init, valid,
                                 10)
        up, cp, mp = feature_align.align2d(t(img), t(ref), t(gx), t(gy),
                                           t(init), t(valid), 10)
        cj = np.asarray(cj)
        assert (cj == cp.numpy()).mean() >= 0.95
        both = cj & cp.numpy()
        close(up.numpy()[both], np.asarray(uj)[both], atol=5e-3)


class TestDetect:
    def test_score_maps(self, frames):
        img = frames[1][0]
        close(detect.shi_tomasi_score_map(t(img)),
              jdet.shi_tomasi_score_map(img), atol=0.05, rtol=1e-3)
        close(detect.fast_corner_mask(t(img), 20.0),
              jdet.fast_corner_mask(img, 20.0))

    @pytest.mark.parametrize("max_fts", [1200, 50])
    def test_detect_features(self, frames, max_fts):
        img = frames[1][0]
        jcfg = JConfig(max_fts=max_fts)
        cfg = SVOConfig(max_fts=max_fts)
        jp = jpyr.build_pyramid(img, 3)
        occ = np.zeros(jdet.grid_shape(H, W, 20)[0]
                       * jdet.grid_shape(H, W, 20)[1], bool)
        occ[::5] = True
        dj = jdet.detect_features(jp, occ, jcfg)
        dp = detect.detect_features(pyramid.build_pyramid(t(img), 3), t(occ),
                                    cfg)
        # the box sums of the score map are cumsum differences whose fp32
        # rounding differs between the two libraries: a near-tie inside a
        # cell can pick another pixel, so >= 97% of cells must agree exactly
        same = ((dp["valid"].numpy() == np.asarray(dj["valid"]))
                & np.all(dp["px"].numpy() == np.asarray(dj["px"]), -1)
                & (dp["level"].numpy() == np.asarray(dj["level"])))
        assert same.mean() >= 0.97, same.mean()
        assert int(dp["valid"].sum()) <= max_fts

    def test_lexsort_budget_ties(self):
        """The budget keeps exactly max_fts cells, ties by index."""
        score = np.array([5, 7, 7, 1, 7, 0], np.float32)
        valid = np.array([1, 1, 1, 1, 0, 1], bool)
        keys = (-score, -np.ones(6, np.int32), ~valid)
        oj = np.asarray(jnp.lexsort(keys))
        op = detect._lexsort((t(-score), -torch.ones(6, dtype=torch.int32),
                              t(~valid).to(torch.int32)))
        np.testing.assert_array_equal(op.numpy(), oj)

    def test_grid_and_cell_index(self):
        assert detect.grid_shape(H, W, 20) == jdet.grid_shape(H, W, 20)
        px = np.array([[0.0, 0.0], [19.9, 20.0], [319.0, 239.0]], np.float32)
        close(detect.cell_index(t(px), W, 20, 16),
              jdet.cell_index(px, W, 20, 16))


def _rel_pose(poses):
    T = poses[1].inverse().compose(poses[0])
    return T, SE3(q=t(T.q), t=t(T.t))


class TestSparseAlign:
    def test_level_substack_and_jacobian(self, frames):
        stk = jpyr.build_stack(frames[1][0], 5)
        for level in range(5):
            a = jsa.level_substack(stk, level, H, W)
            b = sparse_align.level_substack(t(stk), level, H, W)
            assert tuple(b.shape) == a.shape
        p = np.random.default_rng(5).random((10, 3)).astype(np.float32) + 1
        close(sparse_align._geo_jacobian(t(p)), jsa._geo_jacobian(p),
              atol=1e-4)

    @staticmethod
    def _problem(frames, pcam, eps):
        jc, imgs, poses = frames
        jcfg = JConfig(img_align_eps=eps, img_align_n_iter=15)
        cfg = SVOConfig(img_align_eps=eps, img_align_n_iter=15)
        s0 = jpyr.build_stack(imgs[0], 5)
        s1 = jpyr.build_stack(imgs[1], 5)
        det = jdet.detect_features(jpyr.build_pyramid(imgs[0], 3), None, jcfg)
        px = det["px"]
        f = jc.cam2world(px)
        d = jsyn.true_depth(jc, poses[0], px)
        jargs = (s0, s1, jc, JSE3.identity(), px, f, d, det["valid"], jcfg)
        pargs = (t(s0), t(s1), pcam, SE3.identity(), t(px), t(f), t(d),
                 t(det["valid"]), cfg)
        return jargs, pargs

    # eps=1e-3 makes the `small`-update exit end levels early (the loop
    # exit that is not freeze-safe and that the port breaks on the host);
    # 1e-7 runs to the rollback exit.  Poses: 1e-5 on the full path, 3e-5
    # with the early exit (one iteration's fp32 reassociation carried).
    @pytest.mark.parametrize("eps,tol", [(1e-7, 1e-5), (1e-3, 3e-5)])
    def test_sparse_img_align(self, frames, pcam, eps, tol):
        jargs, pargs = self._problem(frames, pcam, eps)
        Tj, nj, cj = jsa.sparse_img_align(*jargs)
        Tp, np_, cp = sparse_align.sparse_img_align(*pargs)
        close(Tp.q, Tj.q, atol=tol)
        close(Tp.t, Tj.t, atol=tol)
        assert abs(int(np_) - int(nj)) <= 1
        close(cp, cj, rtol=1e-3, atol=1e-3)

    def test_small_exit_stops_early(self, frames, pcam, monkeypatch):
        from android_svo_tpu_torch.ops import patch_kernels as pk
        real = pk.sample_patches
        calls = []

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(pk, "sample_patches", counting)
        n = {}
        for eps in (1e-7, 1e-3):
            calls.clear()
            sparse_align.sparse_img_align(*self._problem(frames, pcam,
                                                         eps)[1])
            n[eps] = len(calls)
        assert n[1e-3] < n[1e-7], n

    def test_lm_raises(self, frames, pcam):
        with pytest.raises(NotImplementedError):
            sparse_align.sparse_img_align(None, None, pcam, None, None, None,
                                          None, None, SVOConfig(), "lm")


class TestMatcher:
    @pytest.fixture(scope="class")
    def warp_problem(self, frames):
        jc, imgs, poses = frames
        stk = np.stack([np.asarray(jpyr.build_stack(imgs[0], 5)),
                        np.asarray(jpyr.build_stack(imgs[1], 5))])
        rng = np.random.default_rng(6)
        n = 40
        px = (30 + rng.random((n, 2)) * [W - 60, H - 60]).astype(np.float32)
        lvl = rng.integers(0, 3, n).astype(np.int32)
        f = np.asarray(jc.cam2world(px))
        d = np.asarray(jsyn.true_depth(jc, poses[0], px))
        Tj, Tp = _rel_pose(poses)
        return dict(stk=stk, px=px, lvl=lvl, f=f, d=d, Tj=Tj, Tp=Tp,
                    kf=np.zeros(n, np.int32), valid=np.ones(n, bool))

    def test_warp_and_level(self, frames, pcam, warp_problem):
        x = warp_problem
        jc = frames[0]
        Aj = jmatch.get_warp_matrix_affine(jc, x["px"], x["f"], x["d"],
                                           x["Tj"], x["lvl"], 4)
        Ap = matcher.get_warp_matrix_affine(pcam, t(x["px"]), t(x["f"]),
                                            t(x["d"]), x["Tp"], t(x["lvl"]),
                                            4)
        close(Ap, Aj, atol=1e-4)
        big = np.asarray(Aj) * 2.5
        close(matcher.get_best_search_level(t(big), 2),
              jmatch.get_best_search_level(big, 2))
        sl = np.asarray(jmatch.get_best_search_level(Aj, 2))
        pj, oj = jmatch.warp_affine_stack(x["stk"], x["kf"], Aj, x["px"],
                                          x["lvl"], sl, 5, H, W)
        pp_, op = matcher.warp_affine_stack(t(x["stk"]), t(x["kf"]), Ap,
                                            t(x["px"]), t(x["lvl"]), t(sl), 5,
                                            H, W)
        close(op, oj)
        close(pp_, pj, atol=0.05)

    def test_compute_warp_batch_and_identity(self, frames, pcam,
                                             warp_problem):
        x = warp_problem
        jcfg, cfg = JConfig(), SVOConfig()
        jr = jmatch.compute_warp_batch(x["stk"], x["kf"], frames[0], x["px"],
                                       x["f"], x["d"], x["lvl"], x["Tj"],
                                       x["valid"], jcfg)
        pr = matcher.compute_warp_batch(t(x["stk"]), t(x["kf"]), pcam,
                                        t(x["px"]), t(x["f"]), t(x["d"]),
                                        t(x["lvl"]), x["Tp"], t(x["valid"]),
                                        cfg)
        close(pr[0], jr[0], atol=0.05)
        close(pr[1], jr[1])
        close(pr[3], jr[3])
        ji = jmatch.identity_warp_patches(x["stk"], x["kf"], x["px"],
                                          x["lvl"], x["valid"], jcfg, H, W)
        pi = matcher.identity_warp_patches(t(x["stk"]), t(x["kf"]),
                                           t(x["px"]), t(x["lvl"]),
                                           t(x["valid"]), cfg, H, W)
        for a, b in zip(pi, ji):
            close(a, b, atol=1e-3)

    def test_zmssd(self):
        rng = np.random.default_rng(7)
        r = rng.random((6, 64)).astype(np.float32) * 255
        c = rng.random((6, 3, 64)).astype(np.float32) * 255
        close(matcher.zmssd(t(r), t(c)), jmatch.zmssd(r, c), rtol=1e-4,
              atol=1.0)

    @pytest.mark.parametrize("align_mxu", [True, False])
    def test_match_cached(self, frames, pcam, warp_problem, align_mxu):
        """Cached direct match, both feature-align schedules (the non-mxu
        schedule gates through _zmssd_accept)."""
        x = warp_problem
        jc = frames[0]
        jcfg, cfg = JConfig(align_mxu=align_mxu), SVOConfig(align_mxu=align_mxu)
        pb, sl, _, ok = jmatch.compute_warp_batch(
            x["stk"], x["kf"], jc, x["px"], x["f"], x["d"], x["lvl"],
            x["Tj"], x["valid"], jcfg)
        cur = jpyr.build_stack(frames[1][1], 5)
        p_cur = np.asarray(jc.world2cam(x["Tj"].apply(
            x["f"] * x["d"][:, None])))
        init = p_cur + 0.7
        pj, sj = jmatch.match_cached(cur, jc, pb, sl, init, ok, jcfg)
        pp_, sp = matcher.match_cached(t(cur), pcam, t(pb), t(sl), t(init),
                                       t(ok), cfg)
        sj = np.asarray(sj)
        assert (sj == sp.numpy()).mean() >= 0.95
        both = sj & sp.numpy()
        assert both.sum() >= 10
        # positions in level-0 px: search levels scale the ICLK's 5e-3
        close(pp_.numpy()[both], np.asarray(pj)[both], atol=2e-2)

    def test_find_epipolar_match(self, frames, pcam, warp_problem):
        x = warp_problem
        jc = frames[0]
        jcfg, cfg = JConfig(), SVOConfig()
        cur = jpyr.build_stack(frames[1][1], 5)
        pb, sl, _, ok = jmatch.compute_warp_batch(
            x["stk"], x["kf"], jc, x["px"], x["f"], x["d"], x["lvl"],
            x["Tj"], x["valid"], jcfg)
        d_min = (x["d"] * 0.8).astype(np.float32)
        d_max = (x["d"] * 1.25).astype(np.float32)
        dj, pj, sj = jmatch.find_epipolar_match(
            cur, x["stk"], x["kf"], jc, x["px"], x["f"], x["lvl"], x["Tj"],
            x["d"], d_min, d_max, ok, jcfg, cached=(pb, sl))
        dp, pp_, sp = matcher.find_epipolar_match(
            t(cur), t(x["stk"]), t(x["kf"]), pcam, t(x["px"]), t(x["f"]),
            t(x["lvl"]), x["Tp"], t(x["d"]), t(d_min), t(d_max), t(ok), cfg,
            cached=(t(pb), t(sl)))
        sj = np.asarray(sj)
        assert (sj == sp.numpy()).mean() >= 0.95
        both = sj & sp.numpy()
        assert both.sum() >= 0.5 * len(sj)
        close(dp.numpy()[both], np.asarray(dj)[both], atol=2e-3, rtol=1e-3)
        # and the found depths are right (true depth within 2%)
        rel = np.abs(dp.numpy()[both] / x["d"][both] - 1.0)
        assert np.median(rel) < 0.02

    @pytest.mark.parametrize("field,value,fn", [
        ("epi_search_1d", True, "find_epipolar_match"),
        ("edgelet_detection", True, "match_cached")])
    def test_unported_branches_raise(self, field, value, fn):
        cfg = SVOConfig(**{field: value})
        args = [None] * 12 + [cfg] if fn == "find_epipolar_match" else \
            [None] * 6 + [cfg]
        with pytest.raises(NotImplementedError, match=field):
            getattr(matcher, fn)(*args)
