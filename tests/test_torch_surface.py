"""The public names the port's last slice added, each against its JAX twin
on the CPU: SE3's matrix forms and `distance`, the robust scales and
weights, `essential_from_pose`, the pinhole camera's `has_distortion` and
`is_in_frame`, `true_depth` and `make_trajectory`, the pyramid's level
views, `extract_patches_with_grad`, `align1d`, `KeyframeArena.T_kw` and
`pose`, `rpe_stats`, the config presets, `cfg_use_pallas`,
`GateReport.as_dict` and the kernel cache of `utils/cache.py`.

Inputs are made with numpy from a seed (images with the JAX renderer) and
handed to both packages.  Tolerances: integer, boolean and shape helpers and
the config presets exact; geometry (SE3, robust, triangulation, camera,
`true_depth`, `make_trajectory`) 1e-5; `extract_patches_with_grad` 1e-4;
`align1d` equal flags and uv within 1e-4; `rpe_stats` 1e-9 (both are numpy
in float64).  No case runs a JAX FrameHandler or a Pallas kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.core import state as jst
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.evals import trajectory as jtraj
from android_svo_tpu.geometry import robust as jrobust
from android_svo_tpu.geometry import se3 as jse3
from android_svo_tpu.geometry import triangulation as jtri
from android_svo_tpu.geometry.camera import PinholeCamera as JPinhole
from android_svo_tpu.ops import detect as jdetect
from android_svo_tpu.ops import feature_align as jfa
from android_svo_tpu.ops import interp as jinterp
from android_svo_tpu.ops import patch_pallas as pp
from android_svo_tpu.ops import pyramid as jpyr
from android_svo_tpu.ops import silicon_gate as jgate

from android_svo_tpu_torch.config import PORT_FIELDS, SVOConfig
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.evals import trajectory
from android_svo_tpu_torch.geometry import robust, se3, triangulation
from android_svo_tpu_torch.geometry.camera import PinholeCamera
from android_svo_tpu_torch.ops import cuda_build, detect, feature_align
from android_svo_tpu_torch.ops import interp, pyramid, silicon_gate
from android_svo_tpu_torch.ops import patch_kernels as pk
from android_svo_tpu_torch.utils import cache

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

GEOM_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, tol=GEOM_TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=tol,
                               rtol=0)


def random_twists(seed, n):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((n, 6)).astype(np.float32)
    xi[:, 3:] *= 0.8
    return xi


# jitted: one compile per shape, where eager JAX compiles op by op
JAX_EXP = jax.jit(jse3.SE3.exp)
JAX_FROM_MATRIX = jax.jit(jse3.SE3.from_matrix)
JAX_AS_MATRIX = jax.jit(jse3.SE3.as_matrix)


def poses(xi):
    """The same poses in both packages: SE3.exp of the same twists."""
    return JAX_EXP(jnp.asarray(xi)), se3.SE3.exp(t(xi))


def same_pose(port, ref, tol=GEOM_TOL):
    close(port.q, ref.q, tol)
    close(port.t, ref.t, tol)


# ---- geometry/se3.py ---------------------------------------------------------

@pytest.mark.parametrize("rows", [4, 3])
def test_se3_from_matrix(rows):
    """(..., 4, 4) and (..., 3, 4) matrices, from tensors and from numpy
    (the port puts the array on the device it is given)."""
    J, P = poses(random_twists(0, 8))
    m = np.asarray(JAX_AS_MATRIX(J))[:, :rows]
    ref = JAX_FROM_MATRIX(jnp.asarray(m))
    same_pose(se3.SE3.from_matrix(t(m)), ref)
    from_np = se3.SE3.from_matrix(m, device="cpu")
    assert from_np.q.device.type == "cpu"
    same_pose(from_np, ref)


def test_se3_as_matrix_and_batch_shape():
    J, P = poses(random_twists(1, 12).reshape(3, 4, 6))
    assert tuple(P.batch_shape) == tuple(J.batch_shape) == (3, 4)
    assert tuple(P.as_matrix().shape) == (3, 4, 4, 4)
    close(P.as_matrix(), JAX_AS_MATRIX(J))
    J0, P0 = poses(random_twists(1, 1)[0])
    assert tuple(P0.batch_shape) == tuple(J0.batch_shape) == ()
    close(P0.as_matrix(), JAX_AS_MATRIX(J0))


def test_se3_from_matrix_roundtrip():
    """tests/test_geometry.py:79 on the port."""
    _, P = poses(random_twists(2, 8))
    close(se3.SE3.from_matrix(P.as_matrix()).as_matrix(), P.as_matrix())


@pytest.mark.parametrize("other", ["pose", "points"])
def test_se3_matmul(other):
    Ja, Pa = poses(random_twists(3, 5))
    Jb, Pb = poses(random_twists(4, 5))
    if other == "pose":
        same_pose(Pa @ Pb, Ja @ Jb)
    else:
        pts = np.random.default_rng(5).standard_normal((5, 3)).astype(
            np.float32)
        close(Pa @ t(pts), Ja @ jnp.asarray(pts))


@pytest.mark.parametrize("idx", [2, slice(1, 4), "mask"])
def test_se3_getitem(idx):
    J, P = poses(random_twists(6, 6))
    if idx == "mask":
        m = np.array([True, False, True, True, False, True])
        same_pose(P[t(m)], J[jnp.asarray(m)])
    else:
        same_pose(P[idx], J[idx])


def test_se3_distance():
    Ja, Pa = poses(random_twists(7, 16))
    Jb, Pb = poses(random_twists(8, 16))
    for port, ref in zip(se3.distance(Pa, Pb),
                         jax.jit(jse3.distance)(Ja, Jb)):
        close(port, ref)
    d_t, d_r = se3.distance(Pa, Pa)
    close(d_t, np.zeros(16))
    close(d_r, np.zeros(16), 1e-3)     # the angle of a rounded identity


# ---- geometry/robust.py --------------------------------------------------------

def _residuals(seed, n=512):
    rng = np.random.default_rng(seed)
    x = (rng.standard_t(5, n) * 1.7).astype(np.float32)
    mask = rng.random(n) < 0.8
    return x, mask


def test_robust_tdist_dof():
    assert robust.TDIST_DOF == jrobust.TDIST_DOF


@pytest.mark.parametrize("n", [7, 8, 512])
def test_robust_masked_median(n):
    """Exact: the same element of the same sorted values."""
    x, mask = _residuals(n, n)
    got = robust.masked_median(t(x), t(mask))
    assert float(got) == float(jrobust.masked_median(jnp.asarray(x),
                                                     jnp.asarray(mask)))


@pytest.mark.parametrize("fn", ["normal_scale", "tdist_scale",
                                "tdist_scale_3"])
def test_robust_scales(fn):
    x, mask = _residuals(1)
    kw = {"n_iter": 3} if fn.endswith("_3") else {}
    name = fn.removesuffix("_3")
    got = getattr(robust, name)(t(x), t(mask), **kw)
    ref = getattr(jrobust, name)(jnp.asarray(x), jnp.asarray(mask), **kw)
    close(got, ref)
    none = np.zeros_like(mask)                 # an empty arena: the floor
    close(getattr(robust, name)(t(x), t(none)),
          getattr(jrobust, name)(jnp.asarray(x), jnp.asarray(none)))


@pytest.mark.parametrize("fn", ["unit_weight", "tdist_weight"])
def test_robust_weights(fn):
    x, _ = _residuals(2)
    close(getattr(robust, fn)(t(x)), getattr(jrobust, fn)(jnp.asarray(x)))


# ---- geometry/triangulation.py ---------------------------------------------------

def test_essential_from_pose():
    J, P = poses(random_twists(9, 10))
    close(triangulation.essential_from_pose(P),
          jtri.essential_from_pose(J))
    # and the epipolar constraint it encodes (tests/test_geometry.py:230)
    p_ref = np.array([[0.2, 0.1, 3.0], [-0.5, 0.4, 5.0]], np.float32)
    T = se3.SE3.exp(t(np.array([0.4, 0.1, 0.0, 0.0, 0.05, 0.0],
                               np.float32)))
    p_cur = T.apply(t(p_ref))
    f_ref = t(p_ref) / torch.linalg.norm(t(p_ref), dim=-1, keepdim=True)
    f_cur = p_cur / torch.linalg.norm(p_cur, dim=-1, keepdim=True)
    err = triangulation.sampson_error(triangulation.essential_from_pose(T),
                                      f_ref, f_cur)
    close(err, np.zeros(2), 1e-8)


# ---- geometry/camera.py ------------------------------------------------------------

EUROC = (752, 480, 458.654, 457.296, 367.215, 248.375,
         -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)


@pytest.mark.parametrize("distorted", [False, True])
def test_camera_has_distortion(distorted):
    args = EUROC if distorted else EUROC[:6]
    cam = PinholeCamera.create(*args, device="cpu")
    assert cam.has_distortion is JPinhole.create(*args).has_distortion
    assert cam.has_distortion is distorted


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("boundary", [0.0, 5.0, 15.0])
def test_camera_is_in_frame(level, boundary):
    """Pixels spread over and past the image, some on the level's edges."""
    rng = np.random.default_rng(level)
    px = (rng.random((256, 2)) * [900.0, 600.0] - [80.0, 60.0]).astype(
        np.float32)
    w, h = 752 / 2 ** level, 480 / 2 ** level
    px[:8] = [[boundary, boundary], [w - boundary, 10.0],
              [w - boundary - 0.01, 10.0], [10.0, h - boundary],
              [10.0, h - boundary - 0.01], [boundary - 0.01, 10.0],
              [0.0, 0.0], [w, h]]
    cam = PinholeCamera.create(*EUROC, device="cpu")
    got = cam.is_in_frame(t(px), boundary=boundary, level=level)
    ref = JPinhole.create(*EUROC).is_in_frame(jnp.asarray(px),
                                              boundary=boundary, level=level)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.bool


# ---- data/synthetic.py ---------------------------------------------------------------

@pytest.mark.parametrize("size", [(128, 96), (320, 240)])
def test_true_depth(size):
    """Depth along each pixel's ray to the plane, at tilted poses."""
    w, h = size
    rng = np.random.default_rng(w)
    px = (rng.random((64, 2)) * [w - 1.0, h - 1.0]).astype(np.float32)
    px[0] = [w / 2 - 0.5, h / 2 - 0.5]         # the principal ray
    for x, y, z, rot in ((0.0, 0.0, -2.5, (0.0, 0.0, 0.0)),
                         (0.3, -0.1, -3.0, (0.45, 0.02, 0.1))):
        got = synthetic.true_depth(
            synthetic.default_camera(w, h, device="cpu"),
            synthetic.lookdown_pose(x, y, z, rot, device="cpu"), t(px))
        ref = jsyn.true_depth(jsyn.default_camera(w, h),
                              jsyn.lookdown_pose(x, y, z, rot),
                              jnp.asarray(px))
        close(got, ref)
        if rot == (0.0, 0.0, 0.0):              # tests/test_image_ops.py:53
            close(got[0], -z, 1e-4)


@pytest.mark.parametrize("n", [1, 2, 24])
def test_make_trajectory(n):
    got = synthetic.make_trajectory(n, device="cpu")
    ref = jsyn.make_trajectory(n)
    assert len(got) == len(ref) == n
    for a, b in zip(got, ref):
        assert a.t.device.type == "cpu"
        same_pose(a, b)


# ---- ops/pyramid.py -------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(240, 320), (480, 752), (37, 51)])
def test_pyramid_shapes(hw):
    assert pyramid.pyramid_shapes(*hw, 5) == list(jpyr.pyramid_shapes(*hw, 5))


@pytest.mark.parametrize("hw", [(240, 320), (480, 752)])
def test_level_view_and_stack_levels(hw):
    """Exact: the same pixels of the same padded stack, as views."""
    h, w = hw
    img = np.random.default_rng(h).random((h, w)).astype(np.float32) * 255
    jstack = jpyr.build_stack(jnp.asarray(img), 4)
    stack = t(jstack)                            # the same padded stack
    for lv in range(4):
        a = pyramid.level_view(stack, lv, h, w)
        assert a.data_ptr() >= stack.data_ptr()      # a view, no copy
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(jpyr.level_view(jstack, lv, h, w)))
    for n_levels in (None, 2):
        got = pyramid.stack_levels(stack, h, w, n_levels)
        ref = jpyr.stack_levels(jstack, h, w, n_levels)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- ops/interp.py ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def texture():
    """tests/test_matching.py's image: the 256 px texture of key 3."""
    return np.asarray(jsyn.make_texture(jax.random.PRNGKey(3), 256))


@pytest.mark.parametrize("half", [2, 4])
def test_extract_patches_with_grad(texture, half):
    """Centres over the whole image, some past its border (clamped)."""
    rng = np.random.default_rng(half)
    c = (rng.random((96, 2)) * 276.0 - 10.0).astype(np.float32)
    got = interp.extract_patches_with_grad(t(texture), t(c), half)
    ref = jinterp.extract_patches_with_grad(jnp.asarray(texture),
                                            jnp.asarray(c), half)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == (96, 2 * half, 2 * half)
        close(a, b, 1e-4)


def test_extract_patches_with_grad_ramp():
    """tests/test_image_ops.py:141 on the port: on I = 3x + 7y the sampled
    gradient is exact."""
    xx, yy = np.meshgrid(np.arange(32.0), np.arange(32.0), indexing="xy")
    img = t((3.0 * xx + 7.0 * yy).astype(np.float32))
    _, dx, dy = interp.extract_patches_with_grad(
        img, t(np.array([[10.3, 12.7], [5.5, 20.1]], np.float32)), 2)
    close(dx, np.full((2, 4, 4), 3.0), 1e-4)
    close(dy, np.full((2, 4, 4), 7.0), 1e-4)


# ---- ops/feature_align.py ------------------------------------------------------------------

# jitted: one compile per shape, where eager JAX compiles op by op
JAX_ALIGN1D = jax.jit(jfa.align1d, static_argnames="n_iter")
ALIGN1D_CASES = {
    # tests/test_matching.py:86: two features started 1.5 px along (0.8, 0.6)
    "matching_86": ([[100.0, 80.0], [150.0, 150.0]], [[0.8, 0.6]] * 2,
                    [1.5, 1.5], [True, True], 15),
    "back_and_dead": ([[100.0, 80.0], [150.0, 150.0], [60.0, 190.0]],
                      [[0.8, 0.6], [0.0, 1.0], [-0.6, 0.8]],
                      [-1.0, 2.0, 0.5], [True, True, False], 15),
    "near_border": ([[6.0, 120.0], [249.0, 30.0], [128.0, 128.0]],
                    [[1.0, 0.0], [0.6, 0.8], [0.8, -0.6]],
                    [-1.5, 1.5, 0.7], [True, True, True], 10),
}


@pytest.mark.parametrize("case", sorted(ALIGN1D_CASES))
def test_align1d(texture, case):
    centers, direction, shift, valid, n_iter = (
        np.asarray(v, np.float32) if i < 3 else v
        for i, v in enumerate(ALIGN1D_CASES[case]))
    valid = np.asarray(valid)
    half = SVOConfig().patch_halfsize
    pb = jinterp.extract_patches(jnp.asarray(texture), jnp.asarray(centers),
                                 half + 1)
    ref, gx, gy = (np.asarray(a) for a in jfa.patch_gradients(pb))
    init = centers + shift[:, None] * direction
    uj, cj, mj = JAX_ALIGN1D(jnp.asarray(texture), jnp.asarray(ref),
                             jnp.asarray(gx), jnp.asarray(gy),
                             jnp.asarray(direction), jnp.asarray(init),
                             jnp.asarray(valid), n_iter=n_iter)
    up, cp, mp = feature_align.align1d(t(texture), t(ref), t(gx), t(gy),
                                       t(direction), t(init), t(valid),
                                       n_iter=n_iter)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    close(up, uj, 1e-4)
    close(mp, mj, 1e-3)
    if case == "matching_86":                   # the JAX test's own checks
        assert bool(cp.all())
        close(up, centers, 0.1)


# ---- core/state.py -------------------------------------------------------------------------

def test_keyframe_arena_pose():
    """Arenas of 4 keyframes with the same poses; the other fields are
    placeholders, which neither accessor reads."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((4, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tk = rng.standard_normal((4, 3)).astype(np.float32)
    rest = [f.name for f in dataclasses.fields(st.KeyframeArena)
            if f.name not in ("q_kw", "t_kw")]
    assert rest == [f.name for f in dataclasses.fields(jst.KeyframeArena)
                    if f.name not in ("q_kw", "t_kw")]
    jk = jst.KeyframeArena(q_kw=jnp.asarray(q), t_kw=jnp.asarray(tk),
                           **{k: jnp.zeros(4) for k in rest})
    kfs = st.KeyframeArena(q_kw=t(q), t_kw=t(tk),
                           **{k: torch.zeros(4) for k in rest})
    same_pose(kfs.T_kw, jk.T_kw, 0.0)
    for k in range(4):
        same_pose(kfs.pose(k), jk.pose(k), 0.0)
    same_pose(kfs.pose(t(np.array([3, 1]))), jk.pose(jnp.array([3, 1])), 0.0)


# ---- evals/trajectory.py ------------------------------------------------------------------

@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_stats(delta):
    rng = np.random.default_rng(delta)
    gt = np.cumsum(rng.standard_normal((60, 3)) * 0.05, axis=0)
    est = 0.7 * gt @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + 0.3
    est += rng.standard_normal(est.shape) * 2e-3
    got = trajectory.rpe_stats(est, gt, delta)
    ref = jtraj.rpe_stats(est, gt, delta)
    assert all(isinstance(v, float) for v in got)
    close(got, ref, 1e-9)


# ---- config.py ----------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["android_defaults", "upstream_defaults"])
def test_config_presets_field_by_field(preset):
    got = getattr(SVOConfig, preset)()
    ref = getattr(JConfig, preset)()
    assert isinstance(got, SVOConfig)
    fields = dataclasses.asdict(got)
    # the port's own fields keep their defaults, the JAX package's rule
    assert {k: fields.pop(k) for k in PORT_FIELDS} == {
        k: getattr(SVOConfig(), k) for k in PORT_FIELDS}
    assert fields == dataclasses.asdict(ref)
    assert got.grid_size == (30 if preset == "upstream_defaults" else 20)


def test_upstream_defaults_refused_by_both_detectors():
    """A fault of the reference, copied and pinned: upstream_defaults() sets
    grid_size=30, which 2**(n_pyr_levels - 1) = 4 does not divide, and both
    packages' detectors assert that it does: the preset cannot track in
    either (at 320x240 here)."""
    cfg = SVOConfig.upstream_defaults()
    assert cfg.grid_size % 2 ** (cfg.n_pyr_levels - 1) != 0
    img = np.random.default_rng(0).random((240, 320)).astype(np.float32)
    jpyr_ = jpyr.build_pyramid(jnp.asarray(img), cfg.n_pyr_levels)
    with pytest.raises(AssertionError) as ref:
        jdetect.detect_features(jpyr_, None, JConfig.upstream_defaults())
    with pytest.raises(AssertionError) as got:
        detect.detect_features(pyramid.build_pyramid(t(img), 3), None, cfg)
    assert str(got.value) == str(ref.value)
    assert "grid_size" in str(got.value)


# ---- ops/patch_kernels.py (cfg_use_pallas) --------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
def test_cfg_use_pallas(use_pallas):
    got = pk.cfg_use_pallas(SVOConfig(use_pallas=use_pallas))
    assert got is pp.cfg_use_pallas(JConfig(use_pallas=use_pallas))
    assert got is (None if use_pallas else False)


def test_auto_dispatch_takes_the_plain_version_on_cpu(texture):
    """None ("auto", what cfg_use_pallas gives) reads as True: on CPU
    tensors every wrapper takes its plain version, as with True."""
    stack = pyramid.build_stack(t(texture), 3)
    rng = np.random.default_rng(8)
    uv = t((rng.random((16, 2)) * 216.0 + 20.0).astype(np.float32))
    lvl = torch.zeros(16, dtype=torch.int32)
    valid = torch.ones(16, dtype=torch.bool)
    pk.reset_launch_counts()
    for up in (None, True, False):
        a = pk.sample_patches(stack, lvl, uv, 4, use_pallas=up)
        assert torch.equal(a, pk.sample_patches(stack, lvl, uv, 4))
        w, o = pk.dump_windows(stack, lvl, uv, valid, use_pallas=up)
        w0, o0 = pk.dump_windows_plain(stack, lvl, uv, valid)
        assert torch.equal(w, w0) and torch.equal(o, o0)
    assert all(v == 0 for v in pk.LAUNCHES.values())


# ---- ops/silicon_gate.py ------------------------------------------------------------------

def test_gate_report_as_dict():
    detail = {"sample.patch": 0.0123456789, "scan.finite_frac": 1.0,
              "align.n_conv_kernel": 700}
    args = dict(ok=False, failures=["epi_scan: only 3/8 finite"],
                detail=detail)
    got = silicon_gate.GateReport(**args, max_abs_err={"x": 1.0}).as_dict()
    assert got == jgate.GateReport(**args).as_dict()
    assert got["detail"]["sample.patch"] == 0.012346


def test_least_times_of_the_pose_and_alignment_kernels():
    """pose_bound and align_bound give the bounds PERF.md's kernel table
    records (912 rows, 10 iterations; 11 frames of 912 rows, 148 iterations
    in all); a batch multiplies the bytes, and the alignment's operations
    follow the iterations summed over the frames, not the batch."""
    ms, by, n_bytes, _ = silicon_gate.pose_bound(912, 10)
    assert (round(ms, 6), by, n_bytes) == (0.000036, "operations", 27576)
    ms, by, n_bytes, flops = silicon_gate.align_bound(912, 148, batch=11)
    assert (round(ms, 5), by) == (0.00286, "operations")
    one = silicon_gate.align_bound(912, 148)
    assert n_bytes == 11 * one[2] and flops == one[3]
    assert silicon_gate.pose_bound(912, 10, batch=11)[2] == 11 * 27576


# ---- utils/cache.py ------------------------------------------------------------------------

def test_default_cache_dir_is_the_kernels_build_dir():
    assert cache.DEFAULT_CACHE_DIR == str(cuda_build.BUILD_DIR)
    assert cache.DEFAULT_CACHE_DIR.endswith("build/torch_kernels")


def test_compilation_cache_reuses_a_built_library(monkeypatch, tmp_path):
    """After enable_compilation_cache(path), build() looks in `path`: a
    library of these sources already there is returned without nvcc."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)

    def no_nvcc(*a, **kw):
        raise AssertionError(f"build() started {a[0][:1]}")

    monkeypatch.setattr(cuda_build.subprocess, "Popen", no_nvcc)
    target = tmp_path / "kernels"
    cache.enable_compilation_cache(str(target))
    assert target.is_dir() and cuda_build.BUILD_DIR == target
    lib = target / f"libtorch_kernels_{cuda_build._digest(cuda_build.sources())}.so"
    lib.write_bytes(b"")
    assert cuda_build.build() == lib
