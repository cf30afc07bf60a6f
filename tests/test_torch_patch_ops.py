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

from android_svo_tpu_torch.ops import interp
from android_svo_tpu_torch.ops import patch_kernels as pk

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

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

    @pytest.mark.parametrize("mode", JAX_MODES)
    def test_first_minimum_and_empty_seeds(self, mode):
        """On a flat stack every in-bounds step scores exactly 0, so the
        first in-bounds step wins: j = 4 of 21 (x = 2.25 + j passes the
        margin 6 at j = 4) and j = 5 of 41 on level 1 (y = 1.5 + j), not
        j = 0.  A seed with no in-bounds position and a seed with 0 steps
        give (0, +inf)."""
        flat = np.zeros((L, H, W), np.float32)
        ua = np.array([[2.25, 60.0], [1.0, 60.0], [100.0, 60.0],
                       [50.0, 1.5]], np.float32)
        ub = np.array([[22.25, 60.0], [4.0, 60.0], [120.0, 60.0],
                       [50.0, 41.5]], np.float32)
        ns = np.array([21, 10, 0, 41], np.int32)
        lvl = np.array([0, 0, 0, 1], np.int32)
        ref = np.zeros((4, 8, 8), np.float32)
        want_t = np.array([0.2, 0.0, 0.0, 0.125], np.float32)
        want_s = np.array([0.0, np.inf, np.inf, 0.0], np.float32)
        tj, sj = pp.epi_scan(jnp.asarray(flat), jnp.asarray(lvl),
                             jnp.asarray(ua), jnp.asarray(ub),
                             jnp.asarray(ref), 41, half=4,
                             n_steps_each=jnp.asarray(ns), h=H, w=W, **mode)
        tp, sp = pk.epi_scan(t(flat), t(lvl), t(ua), t(ub), t(ref), 41,
                             half=4, n_steps_each=t(ns), h=H, w=W)
        for tb, sb in ((np.asarray(tj), np.asarray(sj)),
                       (tp.numpy(), sp.numpy())):
            # t = j / (k - 1): the Pallas kernel multiplies by the
            # reciprocal, the plain versions divide (an ulp apart)
            np.testing.assert_allclose(tb, want_t, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(sb, want_s)


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

    @pytest.mark.parametrize("mode", JAX_MODES)
    def test_nonfinite_start_never_converges(self, stack, problem, mode):
        """The drift is measured from init_uv as given, so a valid feature
        whose start holds NaN or +-inf ends unconverged, whether the
        iterations start from it (the spec) or from it zeroed (the Pallas
        kernel's nan_to_num)."""
        x = problem
        init = x["uv"] + x["off"]
        init[0::5, 0] = np.nan
        init[1::5, 1] = np.inf
        init[2::5, 0] = -np.inf
        bad = ~np.isfinite(init).all(axis=-1)
        assert (bad & x["valid"]).sum() >= 10
        _, cj, _ = pp.align_iclk(
            stack, jnp.asarray(x["lvl"]), jnp.asarray(x["ref"]),
            jnp.asarray(x["dx"]), jnp.asarray(x["dy"]), jnp.asarray(init),
            jnp.asarray(x["valid"]), 10, h=H, w=W, **mode)
        _, cp, _ = pk.align_iclk(
            t(stack), t(x["lvl"]), t(x["ref"]), t(x["dx"]), t(x["dy"]),
            t(init), t(x["valid"]), 10, h=H, w=W)
        cj, cp = np.asarray(cj), cp.numpy()
        assert not cj[bad].any() and not cp[bad].any()
        _conv_agree(cj[~bad], t(cp[~bad]))
        assert cp[~bad].sum() >= 0.8 * (x["valid"] & ~bad).sum()

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
        """The public dump_windows (its plain version on CPU tensors)."""
        x = problem
        wj, oj = pp.dump_windows(stack, jnp.asarray(x["lvl"]),
                                 jnp.asarray(x["uv"]),
                                 jnp.asarray(x["valid"]), **mode)
        wp, op = pk.dump_windows(t(stack), t(x["lvl"]), t(x["uv"]),
                                 t(x["valid"]))
        np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
        m = x["valid"]
        np.testing.assert_array_equal(wp.numpy()[m], np.asarray(wj)[m])

    def test_dump_windows_clamps_match_jax_spec(self, stack, problem):
        """Non-finite, off-plane and edge centres and out-of-range levels
        against the JAX spec path (use_pallas=False): origins equal, every
        row's window equal (both copy dead rows too)."""
        x = problem
        rng = np.random.default_rng(11)
        uv = (rng.random((N, 2)) * [W + 200.0, H + 200.0] - 100.0).astype(
            np.float32)
        uv[::6, 0] = np.nan
        uv[1::6, 1] = np.inf
        uv[2::6] = -np.inf
        uv[3::6] = [[0.0, 0.0], [W - 1.0, H - 1.0], [31.9999, 15.5],
                    [1e6, -1e6], [stack.shape[2], stack.shape[1]],
                    [32.0, 16.0], [64.5, 33.5], [-0.5, -0.5]]
        lvl = rng.integers(-2, L + 2, N).astype(np.int32)
        wj, oj = pp.dump_windows(stack, jnp.asarray(lvl), jnp.asarray(uv),
                                 jnp.asarray(x["valid"]), use_pallas=False)
        wp, op = pk.dump_windows(t(stack), t(lvl), t(uv), t(x["valid"]))
        np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))

    @pytest.mark.parametrize("mode", JAX_MODES)
    @pytest.mark.parametrize("shared", [False, True],
                             ids=["stacks", "shared_stack"])
    def test_vmap_dump_windows_matches_jax_vmap(self, stack, problem, mode,
                                                shared):
        """torch.func.vmap(dump_windows) (the op's vmap rule, its batched
        plain version here) against jax.vmap(dump_windows) (the spec's
        nested vmap, or Pallas' batching rule in interpret mode) on B=3
        frames, the stack batched or shared (in_axes None): origins exactly
        on every row, windows exactly on valid rows (tolerance 0: a copy).
        Centres include non-finite and off-plane ones, levels out of
        range."""
        from functools import partial
        B = 3
        rng = np.random.default_rng(17)
        st = np.asarray(stack)
        stacks = np.stack([st, st * 0.5 + 7.0, st[:, :, ::-1] + 1.0])
        lvl = rng.integers(-1, L + 1, (B, N)).astype(np.int32)
        uv = (rng.random((B, N, 2)) * [W + 80.0, H + 80.0] - 40.0).astype(
            np.float32)
        uv[0, ::5, 0] = np.nan
        uv[1, 1::5, 1] = np.inf
        uv[2, 2::5] = -np.inf
        valid = rng.random((B, N)) < 0.8
        s_j = st if shared else stacks
        in_axes = (None if shared else 0, 0, 0, 0)
        wj, oj = jax.vmap(partial(pp.dump_windows, **mode), in_axes=in_axes)(
            jnp.asarray(s_j), jnp.asarray(lvl), jnp.asarray(uv),
            jnp.asarray(valid))
        wp, op = torch.func.vmap(pk.dump_windows, in_dims=in_axes)(
            t(np.ascontiguousarray(s_j)), t(lvl), t(uv), t(valid))
        assert wp.shape == (B, N, pk.DUMP_WR, pk.DUMP_WC)
        np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(wp.numpy()[valid],
                                      np.asarray(wj)[valid])

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

    def test_window_is_a_predicate(self, stack, problem, monkeypatch):
        """At every ICLK iterate where `inb` holds, every tap of the patch
        and its bilinear neighbour lie inside the 32x64 window, and the
        one-hot window sample equals the stack's bilinear sample at the
        window origin plus the window coordinates: the premise that lets
        the kernel read the stack in place of a staged window.  The
        iterates are those of `_align_mxu_plain`; both samples are taken
        in float64 at them, so rounding cannot hide a misplaced tap."""
        x = problem
        seen = []
        onehot = pk._onehot_patch

        def record(wins, u, v, p):
            seen.append((u.double(), v.double()))
            return onehot(wins, u, v, p)

        monkeypatch.setattr(pk, "_onehot_patch", record)
        st, lvl, valid = t(stack), t(x["lvl"]), t(x["valid"])
        init = t(x["uv"] + x["off"])
        pk.align_iclk_mxu(st, lvl, t(x["ref"]), t(x["dx"]), t(x["dy"]),
                          init, valid, 10, h=H, w=W)
        assert len(seen) == 11                 # 10 iterations + resample
        p = x["ref"].shape[1]
        half = p // 2
        wins, org = pk.dump_windows_plain(st, lvl, init, valid)
        wins, org, st = wins.double(), org.double(), st.double()
        wl = (W >> lvl.long()).double()
        hl = (H >> lvl.long()).double()
        m, wb = half + 1.0, half + 2.0
        offs = interp.patch_offsets(half, torch.float64)
        n_checked = 0
        for uw, vw in seen:
            u, v = uw + org[:, 0], vw + org[:, 1]
            inb = (valid & (u >= m) & (u < wl - 1 - m) & (v >= m)
                   & (v < hl - 1 - m) & (uw >= wb)
                   & (uw < pk.DUMP_WC - 1 - wb) & (vw >= wb)
                   & (vw < pk.DUMP_WR - 1 - wb))
            tap = torch.stack([uw, vw], -1)[:, None, :] + offs[None]
            lo = torch.floor(tap)
            assert (lo[inb] >= 0).all()
            assert (lo[inb][..., 0] + 1 <= pk.DUMP_WC - 1).all()
            assert (lo[inb][..., 1] + 1 <= pk.DUMP_WR - 1).all()
            a = onehot(wins, uw, vw, p).reshape(N, -1)
            b = interp.bilinear_sample_stack(st, lvl, org[:, None, :] + tap)
            np.testing.assert_allclose(a[inb].numpy(), b[inb].numpy(),
                                       atol=1e-5, rtol=0)
            n_checked += int(inb.sum())
        assert n_checked >= 2 * int(x["valid"].sum())

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

    @pytest.mark.parametrize("bad", ["lvl_int64", "uv_float64",
                                     "valid_uint8", "uv_shape",
                                     "lvl_strided"])
    def test_sampler_checks_before_launch(self, stack, problem, bad):
        """The CUDA path converts nothing: another type, shape or layout
        raises before any allocation or launch (its checks run here)."""
        x = problem
        lvl, uv, valid = t(x["lvl"]), t(x["uv"]), t(x["valid"])
        if bad == "lvl_int64":
            lvl = lvl.long()
        elif bad == "uv_float64":
            uv = uv.double()
        elif bad == "valid_uint8":
            valid = valid.to(torch.uint8)
        elif bad == "uv_shape":
            uv = uv[:-1]
        else:
            lvl = torch.stack([lvl, lvl], -1)[:, 0]
        pk.reset_launch_counts()
        err = TypeError if bad.endswith(("int64", "float64", "uint8")) \
            else ValueError
        with pytest.raises(err):
            pk._sample_kernel(t(stack), lvl, uv, 2, True, valid)
        assert all(v == 0 for v in pk.LAUNCHES.values())

    @pytest.mark.parametrize("bad", ["lvl_int64", "uv_float64",
                                     "valid_uint8", "valid_none", "uv_shape",
                                     "lvl_strided", "stack_batched",
                                     "stack_too_small", "stack_float64"])
    def test_dump_checks_before_launch(self, stack, problem, bad):
        """dump_windows_kernel's wrapper converts nothing: another type,
        shape or layout raises before any allocation or launch (its checks
        run here)."""
        x = problem
        st, lvl, uv, valid = t(stack), t(x["lvl"]), t(x["uv"]), t(x["valid"])
        if bad == "lvl_int64":
            lvl = lvl.long()
        elif bad == "uv_float64":
            uv = uv.double()
        elif bad == "valid_uint8":
            valid = valid.to(torch.uint8)
        elif bad == "valid_none":
            valid = None
        elif bad == "uv_shape":
            uv = uv[:-1]
        elif bad == "lvl_strided":
            lvl = torch.stack([lvl, lvl], -1)[:, 0]
        elif bad == "stack_batched":
            st = st[None]
        elif bad == "stack_too_small":
            st = st[:, :, :pk.DUMP_WC - 1]
        else:
            st = st.double()
        pk.reset_launch_counts()
        err = TypeError if bad.endswith(("int64", "float64", "uint8",
                                         "none")) else ValueError
        if bad == "stack_float64":
            err = ValueError
        with pytest.raises(err):
            pk._dump_kernel(st, lvl, uv, valid)
        assert all(v == 0 for v in pk.LAUNCHES.values())

    @pytest.mark.parametrize("bad", ["lvl_int64", "uv_float64",
                                     "valid_uint8", "uv_shape",
                                     "lvl_strided", "rows_not_per_frame",
                                     "n_per_zero", "stack_5d",
                                     "stack_cols_strided", "stack_too_small"])
    def test_batched_dump_checks_before_launch(self, stack, problem, bad):
        """The batched dump (two frames' stacks, B * N flat rows) converts
        nothing either: another type, shape or layout, or rows that are not
        n_per per frame, raise before any allocation or launch."""
        x = problem
        st = torch.stack([t(stack), t(stack)])
        lvl = t(np.tile(x["lvl"], 2))
        uv = t(np.tile(x["uv"], (2, 1)))
        valid = t(np.tile(x["valid"], 2))
        n_per = N
        if bad == "lvl_int64":
            lvl = lvl.long()
        elif bad == "uv_float64":
            uv = uv.double()
        elif bad == "valid_uint8":
            valid = valid.to(torch.uint8)
        elif bad == "uv_shape":
            uv = uv[:-1]
        elif bad == "lvl_strided":
            lvl = torch.stack([lvl, lvl], -1)[:, 0]
        elif bad == "rows_not_per_frame":
            n_per = N - 1
        elif bad == "n_per_zero":
            n_per = 0
        elif bad == "stack_5d":
            st = st[None]
        elif bad == "stack_cols_strided":
            st = st.transpose(-1, -2)
        else:
            st = st[..., :pk.DUMP_WR - 1, :]
        pk.reset_launch_counts()
        err = TypeError if bad.endswith(("int64", "float64", "uint8")) \
            else ValueError
        with pytest.raises(err):
            pk._dump_kernel(st, lvl, uv, valid, n_per=n_per)
        assert all(v == 0 for v in pk.LAUNCHES.values())

    @pytest.mark.parametrize("bad", ["init_float64", "valid_none",
                                     "gx_transposed", "patch_too_big"])
    def test_window_checks_before_launch(self, stack, problem, bad):
        x = problem
        args = dict(T=t(x["ref"]), gx=t(x["dx"]), gy=t(x["dy"]),
                    uv0=t(x["uv"] + x["off"]), valid=t(x["valid"]))
        if bad == "init_float64":
            args["uv0"] = args["uv0"].double()
        elif bad == "valid_none":
            args["valid"] = None
        elif bad == "gx_transposed":
            args["gx"] = args["gx"].transpose(1, 2)
        else:
            args = {k: (torch.zeros((N, 12, 12)) if k in "T gx gy" else v)
                    for k, v in args.items()}
        pk.reset_launch_counts()
        with pytest.raises((TypeError, ValueError)):
            pk._align_window_kernel(t(stack), t(x["lvl"]), n_iter=10, h=H,
                                    w=W, zmssd_factor=None,
                                    min_patch_std=None, **args)
        assert all(v == 0 for v in pk.LAUNCHES.values())

    @pytest.mark.parametrize("bad", ["init_float64", "lvl_int64",
                                     "gx_transposed", "patch_too_big"])
    def test_align_checks_before_launch(self, stack, problem, bad):
        x = problem
        args = dict(lvl=t(x["lvl"]), T=t(x["ref"]), gx=t(x["dx"]),
                    gy=t(x["dy"]), uv0=t(x["uv"] + x["off"]),
                    valid=t(x["valid"]))
        if bad == "init_float64":
            args["uv0"] = args["uv0"].double()
        elif bad == "lvl_int64":
            args["lvl"] = args["lvl"].long()
        elif bad == "gx_transposed":
            args["gx"] = args["gx"].transpose(1, 2)
        else:
            args.update(T=torch.zeros((N, 12, 12)),
                        gx=torch.zeros((N, 12, 12)),
                        gy=torch.zeros((N, 12, 12)))
        pk.reset_launch_counts()
        err = TypeError if bad.endswith(("int64", "float64")) else ValueError
        with pytest.raises(err):
            pk._align_kernel(t(stack), n_iter=10, h=H, w=W, **args)
        assert all(v == 0 for v in pk.LAUNCHES.values())

    @pytest.mark.parametrize("bad", ["uv_a_float64", "lvl_int64",
                                     "n_steps_int64", "ref_transposed",
                                     "patch_too_big", "n_steps_strided",
                                     "dims_beyond_stack"])
    def test_scan_checks_before_launch(self, stack, problem, bad):
        x = problem
        uv = t(x["uv"])
        args = dict(lvl=t(x["lvl"]), uv_a=uv - 5.0, uv_b=uv + 5.0,
                    n_steps_each=torch.full((N,), 15, dtype=torch.int32),
                    ref_patch=t(x["ref"]), half=4, h=H, w=W)
        if bad == "uv_a_float64":
            args["uv_a"] = args["uv_a"].double()
        elif bad == "lvl_int64":
            args["lvl"] = args["lvl"].long()
        elif bad == "n_steps_int64":
            args["n_steps_each"] = args["n_steps_each"].long()
        elif bad == "ref_transposed":
            args["ref_patch"] = args["ref_patch"].transpose(1, 2)
        elif bad == "patch_too_big":
            args.update(ref_patch=torch.zeros((N, 12, 12)), half=6)
        elif bad == "n_steps_strided":
            args["n_steps_each"] = torch.full((2 * N,), 15,
                                              dtype=torch.int32)[::2]
        else:
            args["w"] = stack.shape[2] + 1
        pk.reset_launch_counts()
        err = TypeError if bad.endswith(("int64", "float64")) else ValueError
        with pytest.raises(err):
            pk._scan_kernel(t(stack), n_steps_max=30, **args)
        assert all(v == 0 for v in pk.LAUNCHES.values())

    def test_update_count_bounded(self, stack, problem):
        x = problem
        n_upd = pk.count_iclk_updates(
            t(stack), t(x["lvl"]), t(x["ref"]), t(x["dx"]), t(x["dy"]),
            t(x["uv"] + x["off"]), t(x["valid"]), 10, H, W, window=False)
        assert 0 < n_upd <= 10 * int(x["valid"].sum())
