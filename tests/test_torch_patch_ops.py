"""The port's patch-kernel module (`android_svo_tpu_torch/ops/patch_kernels`)
on the CPU, where every wrapper takes its plain PyTorch version, against the
JAX package's `ops/patch_pallas` run both ways: the pure-JAX spec
(`use_pallas=False`) and the Pallas kernel in interpret mode
(`interpret=True`), as tests/test_patch_pallas.py runs it.

Inputs: a rendered 320x240 pyramid and uv/level draws made with numpy from a
seed.  Only valid slots are compared.  Bounds are the JAX package's kernel
gate (ops/silicon_gate.py) unless a tighter one is stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.ops import patch_pallas as pp
from android_svo_tpu.ops.pyramid import build_stack

from android_svo_tpu_torch.ops import patch_kernels as pk

W, H, L = 320, 240, 3
N = 48
JAX_MODES = [pytest.param(dict(use_pallas=False), id="jax_spec"),
             pytest.param(dict(interpret=True), id="pallas_interpret")]


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def stack():
    cam = jsyn.default_camera(W, H)
    tex = jsyn.make_texture(jax.random.PRNGKey(7), 1024)
    img = jsyn.render(tex, cam, jsyn.lookdown_pose(0.0, 0.0, -3.0,
                                                   (0.45, 0.0, 0.0)))
    return build_stack(img, L)


@pytest.fixture(scope="module")
def problem(stack):
    rng = np.random.default_rng(3)
    lvl = rng.integers(0, L, N).astype(np.int32)
    wl = (W >> lvl).astype(np.float32)
    hl = (H >> lvl).astype(np.float32)
    u01 = rng.random((N, 2), dtype=np.float32)
    uv = np.stack([12 + u01[:, 0] * (wl - 24), 12 + u01[:, 1] * (hl - 24)],
                  -1).astype(np.float32)
    off = (rng.random((N, 2), dtype=np.float32) * 4.0 - 2.0)
    ref, dx, dy = pp.sample_patches(stack, jnp.asarray(lvl), jnp.asarray(uv),
                                    4, grad=True, use_pallas=False)
    valid = np.ones((N,), bool)
    valid[::7] = False                     # some dead slots
    return dict(lvl=lvl, uv=uv, off=off, ref=np.asarray(ref),
                dx=np.asarray(dx), dy=np.asarray(dy), valid=valid)


class TestSamplePatches:
    @pytest.mark.parametrize("mode", JAX_MODES)
    @pytest.mark.parametrize("half,grad", [(2, False), (2, True), (4, False),
                                           (4, True)])
    def test_plain_matches_jax(self, stack, problem, half, grad, mode):
        x = problem
        ref = pp.sample_patches(stack, jnp.asarray(x["lvl"]),
                                jnp.asarray(x["uv"]), half, grad,
                                valid=jnp.asarray(x["valid"]), **mode)
        out = pk.sample_patches(t(stack), t(x["lvl"]), t(x["uv"]), half,
                                grad, valid=t(x["valid"]))
        ref = ref if grad else (ref,)
        out = out if grad else (out,)
        m = x["valid"]
        for a, b in zip(ref, out):
            # gate bound 0.02; the plain versions agree to fp32 rounding
            np.testing.assert_allclose(b.numpy()[m], np.asarray(a)[m],
                                       atol=1e-3)

    def test_strided_substack(self, stack, problem):
        """Sparse alignment samples a non-contiguous level slice."""
        from android_svo_tpu.ops.sparse_align import level_substack as jsub
        from android_svo_tpu_torch.ops.sparse_align import level_substack
        sj = jsub(stack, 2, H, W)
        st = level_substack(t(stack), 2, H, W)
        assert not st.is_contiguous()
        uv = problem["uv"] / 4.0
        z = np.zeros((N,), np.int32)
        a = pp.sample_patches(sj, jnp.asarray(z), jnp.asarray(uv), 2,
                              use_pallas=False)
        b = pk.sample_patches(st, t(z), t(uv), 2)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)

    def test_garbage_inputs_are_finite(self, stack):
        uv = np.array([[np.nan, 1e9], [-50.0, -50.0], [1e9, np.nan]],
                      np.float32)
        lvl = np.array([0, 7, -3], np.int32)
        out = pk.sample_patches(t(stack), t(lvl), t(np.nan_to_num(uv)), 4)
        assert torch.isfinite(out).all()


class TestEpiScan:
    @pytest.mark.parametrize("mode", JAX_MODES)
    def test_plain_matches_jax(self, stack, problem, mode):
        x = problem
        rng = np.random.default_rng(4)
        ang = rng.random(N) * 2 * np.pi
        seg = (np.stack([np.cos(ang), np.sin(ang)], -1) * 10.0).astype(
            np.float32)
        ns = rng.integers(0, 30, N).astype(np.int32)   # includes 0 steps
        ua, ub = x["uv"] - seg, x["uv"] + seg
        tj, sj = pp.epi_scan(stack, jnp.asarray(x["lvl"]), jnp.asarray(ua),
                             jnp.asarray(ub), jnp.asarray(x["ref"]), 30,
                             half=4, n_steps_each=jnp.asarray(ns), h=H, w=W,
                             **mode)
        tp, sp = pk.epi_scan(t(stack), t(x["lvl"]), t(ua), t(ub), t(x["ref"]),
                             30, half=4, n_steps_each=t(ns), h=H, w=W)
        sj, tj = np.asarray(sj), np.asarray(tj)
        fin = np.isfinite(sj)
        # +inf (no in-bounds position / 0 steps) agrees exactly
        np.testing.assert_array_equal(np.isfinite(sp.numpy()), fin)
        assert fin.sum() >= 0.6 * N
        # gate bounds: best_t 1e-3, score 2.0
        np.testing.assert_allclose(tp.numpy()[fin], tj[fin], atol=1e-3)
        np.testing.assert_allclose(sp.numpy()[fin], sj[fin], atol=2.0)

    def test_finds_planted_patch(self, stack):
        cx, cy = 120.0, 60.0
        z = np.zeros((1,), np.int32)
        ref = pk.sample_patches(t(stack), t(z), torch.tensor([[cx, cy]]), 4)
        tb, s = pk.epi_scan(t(stack), t(z), torch.tensor([[cx - 8, cy - 4]]),
                            torch.tensor([[cx + 8, cy + 4]]), ref, 33, half=4,
                            h=H, w=W)
        assert abs(float(tb[0]) - 0.5) < 0.04
        assert float(s[0]) < 1.0


def _conv_agree(cj, cp, min_frac=0.95):
    assert (np.asarray(cj) == cp.numpy()).mean() >= min_frac


class TestAlignICLK:
    @pytest.mark.parametrize("mode", JAX_MODES)
    def test_plain_matches_jax(self, stack, problem, mode):
        x = problem
        init = x["uv"] + x["off"]
        uj, cj, mj = pp.align_iclk(
            stack, jnp.asarray(x["lvl"]), jnp.asarray(x["ref"]),
            jnp.asarray(x["dx"]), jnp.asarray(x["dy"]), jnp.asarray(init),
            jnp.asarray(x["valid"]), 10, h=H, w=W, **mode)
        up, cp, mp = pk.align_iclk(
            t(stack), t(x["lvl"]), t(x["ref"]), t(x["dx"]), t(x["dy"]),
            t(init), t(x["valid"]), 10, h=H, w=W)
        cj = np.asarray(cj)
        # convergence agreement >= 0.95 (gate)
        _conv_agree(cj, cp)
        both = cj & cp.numpy()
        assert both.sum() >= 0.8 * x["valid"].sum()
        # converged positions: gate bound 0.05 px; tighter here (fp32
        # rounding only between two plain versions)
        d = np.abs(up.numpy()[both] - np.asarray(uj)[both]).max()
        assert d <= 5e-3, d
        err = np.linalg.norm(up.numpy() - x["uv"], axis=-1)[cp.numpy()]
        assert np.median(err) <= 0.5

    def test_invalid_stays_put(self, stack, problem):
        x = problem
        init = x["uv"] + x["off"]
        up, cp, _ = pk.align_iclk(
            t(stack), t(x["lvl"]), t(x["ref"]), t(x["dx"]), t(x["dy"]),
            t(init), torch.zeros(N, dtype=torch.bool), 6, h=H, w=W)
        np.testing.assert_allclose(up.numpy(), init)
        assert not cp.any()


class TestAlignWindow:
    @pytest.mark.parametrize("mode", JAX_MODES)
    def test_dump_windows_matches_jax(self, stack, problem, mode):
        x = problem
        wj, oj = pp.dump_windows(stack, jnp.asarray(x["lvl"]),
                                 jnp.asarray(x["uv"]),
                                 jnp.asarray(x["valid"]), **mode)
        wp, op = pk.dump_windows_plain(t(stack), t(x["lvl"]), t(x["uv"]),
                                       t(x["valid"]))
        np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
        m = x["valid"]
        np.testing.assert_array_equal(wp.numpy()[m], np.asarray(wj)[m])

    @pytest.mark.parametrize("gated", [False, True])
    @pytest.mark.parametrize("mode", JAX_MODES)
    def test_plain_matches_jax(self, stack, problem, mode, gated):
        x = problem
        init = x["uv"] + x["off"]
        kw = dict(zmssd_factor=2000.0, min_patch_std=5.0) if gated else {}
        uj, cj, _ = pp.align_iclk_mxu(
            stack, jnp.asarray(x["lvl"]), jnp.asarray(x["ref"]),
            jnp.asarray(x["dx"]), jnp.asarray(x["dy"]), jnp.asarray(init),
            jnp.asarray(x["valid"]), 10, h=H, w=W, **mode, **kw)
        up, cp, _ = pk.align_iclk_mxu(
            t(stack), t(x["lvl"]), t(x["ref"]), t(x["dx"]), t(x["dy"]),
            t(init), t(x["valid"]), 10, h=H, w=W, **kw)
        cj = np.asarray(cj)
        _conv_agree(cj, cp)
        both = cj & cp.numpy()
        assert both.sum() >= 0.5 * x["valid"].sum()
        d = np.linalg.norm(up.numpy()[both] - np.asarray(uj)[both], axis=-1)
        # gate: p90 <= 0.05 px and max <= 0.5 px
        assert np.percentile(d, 90) <= 0.05 and d.max() <= 0.5, d.max()
        err = np.linalg.norm(up.numpy() - x["uv"], axis=-1)[cp.numpy()]
        assert np.median(err) <= 0.5

    def test_flat_stack_rejected_by_gate(self, stack, problem):
        x = problem
        flat = torch.full_like(t(stack), 100.0)
        _, cv, _ = pk.align_iclk_mxu(
            flat, t(x["lvl"]), t(x["ref"]), t(x["dx"]), t(x["dy"]),
            t(x["uv"] + x["off"]), t(x["valid"]), 10, h=H, w=W,
            zmssd_factor=2000.0, min_patch_std=5.0)
        assert not cv.any()


class TestDispatch:
    def test_cpu_tensors_take_plain_version(self, stack, problem):
        pk.reset_launch_counts()
        x = problem
        pk.sample_patches(t(stack), t(x["lvl"]), t(x["uv"]), 4)
        assert all(v == 0 for v in pk.LAUNCHES.values())

    def test_update_count_bounded(self, stack, problem):
        x = problem
        n_upd = pk.count_iclk_updates(
            t(stack), t(x["lvl"]), t(x["ref"]), t(x["dx"]), t(x["dy"]),
            t(x["uv"] + x["off"]), t(x["valid"]), 10, H, W, window=False)
        assert 0 < n_upd <= 10 * int(x["valid"].sum())
