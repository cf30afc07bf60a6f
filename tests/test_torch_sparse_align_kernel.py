"""Sparse alignment's dispatch (`ops/sparse_align.py`) on the CPU: CPU
tensors, or `use_pallas` off, take the plain loop, which with every
level's set-up made before the loop gives what the loop gave with each
level's set-up made inside it, bit for bit, with the same iterations,
counters and host reads, and launches nothing; the kernel's form of the
photometric Jacobian is `_level_setup`'s.  The kernel itself is held
against the plain loop on the card (`tests/test_torch_cuda.py`)."""

import pytest
import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import silicon_gate, sparse_align
from android_svo_tpu_torch.ops import sparse_align_gn
from android_svo_tpu_torch.utils import profiling

torch.set_num_threads(1)

N_ROWS = 160


def _scene(seed, camera="radtan", **kw):
    return silicon_gate.align_inputs(seed, camera, n=N_ROWS, device="cpu",
                                     **kw)


def _loop_with_setup_inside(ref_stack, cur_stack, cam, T, ref_px, ref_f,
                            ref_depth, valid, cfg, method="gn",
                            batched=False):
    """The plain loop with each level's set-up made at the top of that
    level's iterations, inside the loop over the levels."""
    lm = method == "lm"
    dtype = ref_px.dtype
    xyz_ref = ref_f * ref_depth[..., None]
    lead = ref_px.shape[:-2]
    vm = torch.func.vmap if batched else (lambda f: f)
    iterations = []
    n_tracked = torch.zeros(lead, dtype=torch.int32)
    chi2_out = torch.zeros(lead, dtype=dtype)
    for level in range(cfg.img_align_max_level,
                       cfg.img_align_min_level - 1, -1):
        ok_ref, patch_ref, J = vm(lambda rs, x, v: sparse_align._level_setup(
            rs, x, v, cam, level, cfg))(ref_stack, xyz_ref, valid)
        carry = (T.q, T.t, T.q, T.t,
                 torch.full(lead, float("inf"), dtype=dtype))
        if lm:
            carry = carry + (torch.full(lead, 0.01, dtype=dtype),)
        step = vm(lambda cs, x, o, p, j, c: sparse_align._align_step(
            cs, x, o, p, j, c, cam, level, cfg, lm))
        active = torch.ones(lead, dtype=torch.bool)
        iterations.append(0)
        for _ in range(cfg.img_align_n_iter):
            new, stop = step(cur_stack, xyz_ref, ok_ref, patch_ref, J, carry)
            iterations[-1] += 1
            profiling.count("align_iters")
            if not batched:
                carry = new
                if profiling.host_read(stop, "align_stop"):
                    break
                continue
            carry = tuple(
                torch.where(active.reshape(lead + (1,) * (c.dim() - 1)),
                            nc, c) for nc, c in zip(new, carry))
            active = active & ~stop
            if not profiling.host_read(active.any(), "align_active"):
                break
        T = SE3(q=carry[2], t=carry[3])
        chi2_out = carry[4]
        if level == cfg.img_align_min_level:
            n_tracked = vm(lambda x, o, q, t: sparse_align._n_tracked(
                x, o, q, t, cam, level, cfg))(xyz_ref, ok_ref, T.q, T.t)
    return (T, n_tracked, chi2_out), iterations


def _recorded(fn):
    mon = profiling.install()
    try:
        out = fn()
    finally:
        profiling.uninstall()
    names = sorted(s.name for s in mon.spans())
    return out, dict(mon.counters), names


def _flat(out):
    T, n, c = out
    return (T.q, T.t, n, c)


@pytest.mark.parametrize("camera", ["radtan", "pinhole", "atan"])
@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_cpu_runs_the_plain_loop_as_before(camera, method, use_pallas):
    """CPU tensors (with the kernels allowed or not) take the plain loop:
    its outputs, its iterations per level, its `align_iters` and its
    `align_stop` reads are the loop's with each level's set-up made
    inside it, bit for bit, and nothing is launched."""
    cfg = SVOConfig(use_pallas=use_pallas, img_align_n_iter=12)
    args = _scene(3, camera, margin=0.1)
    sparse_align_gn.reset_launch_counts()
    got, counts, spans = _recorded(
        lambda: sparse_align.sparse_img_align(*args, cfg, method=method))
    its = list(sparse_align.ITERATIONS)
    (want, want_its), want_counts, want_spans = _recorded(
        lambda: _loop_with_setup_inside(*args, cfg, method))
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 0
    assert int(got[1]) > 0
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    assert its == want_its and sum(its) > len(its)
    assert counts == want_counts
    assert counts["align_iters"] == sum(its)
    assert spans == want_spans
    assert spans.count("host_read.align_stop") == sum(its)


@pytest.mark.parametrize("method", ["gn", "lm"])
def test_cpu_batched_runs_the_plain_loop_as_before(method):
    """The batched form on the CPU: three frames, each stopping where its
    own loop stops; outputs, iterations, counters and `align_active` reads
    as with each level's set-up inside the loop, and no launch."""
    cfg = SVOConfig(img_align_n_iter=12)
    batch = silicon_gate.stack_align_inputs(
        [_scene(5 + s, margin=0.1 * s) for s in range(3)])
    sparse_align_gn.reset_launch_counts()
    got, counts, spans = _recorded(lambda: sparse_align.sparse_img_align(
        *batch, cfg, method=method, batched=True))
    its = list(sparse_align.ITERATIONS)
    (want, want_its), want_counts, want_spans = _recorded(
        lambda: _loop_with_setup_inside(*batch, cfg, method, batched=True))
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 0
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    assert its == want_its
    assert counts == want_counts
    assert spans == want_spans
    assert spans.count("host_read.align_active") == sum(its)
    for b in range(3):                 # each frame as its single call
        one = sparse_align.sparse_img_align(
            *(x[b] if isinstance(x, torch.Tensor) else x for x in batch[:3]),
            SE3(q=batch[3].q[b], t=batch[3].t[b]),
            *(x[b] for x in batch[4:]), cfg, method=method)
        for g, w in zip(_flat(got), _flat(one)):
            assert torch.equal(g[b], w)


@pytest.mark.parametrize("camera", ["radtan", "atan"])
def test_kernel_jacobian_is_level_setups(camera):
    """The photometric Jacobian as the kernel forms it, pixel by pixel from
    gx, gy and the two rows of `_geo_jacobian` written out in closed form
    (a = -x/z^2, b = -y/z^2: row 0 = (1/z, 0, a, a y, z/z - a x, -y/z),
    row 1 = (0, 1/z, b, b y - z/z, -b x, x/z)) times fx and fy at the
    level's scale, equals `_level_setup`'s J at every level (to the
    rounding of its two terms on the few pixels where it is not the same
    bits)."""
    cfg = SVOConfig()
    ref_stack, _, cam, _, _, f, depth, valid = _scene(7, camera)
    xyz = f * depth[..., None]
    for level in range(cfg.img_align_max_level,
                       cfg.img_align_min_level - 1, -1):
        ok, patch, J = sparse_align._level_setup(ref_stack, xyz, valid, cam,
                                                 level, cfg)
        ok2, patch2, gx, gy = sparse_align._level_refs(ref_stack, xyz, valid,
                                                       cam, level, cfg)
        assert torch.equal(ok, ok2) and torch.equal(patch, patch2)
        scale = 1.0 / 2 ** level
        x, y, z = xyz.unbind(-1)
        zi = 1.0 / z
        a, b = -x * zi * zi, -y * zi * zi
        zero = torch.zeros_like(zi)
        row0 = torch.stack([zi, zero, a, a * y, zi * z - a * x, -(zi * y)],
                           -1)
        row1 = torch.stack([zero, zi, b, b * y - zi * z, -(b * x), zi * x],
                           -1)
        a0 = (cam.fx * scale) * row0
        a1 = (cam.fy * scale) * row1
        tx = gx[..., None] * a0[:, None, :]
        ty = gy[..., None] * a1[:, None, :]
        fin = torch.isfinite(J).all(-1).all(-1) & (z > 1e-3)
        assert fin.sum() > N_ROWS // 2
        # equal to the rounding of the two terms: `_geo_jacobian`'s matrix
        # product may fuse a multiply-add where the closed form rounds
        # twice, and gx a0 + gy a1 may cancel
        gap = ((tx + ty) - J)[fin].abs()
        assert bool((gap <= 1e-6 * (tx.abs() + ty.abs())[fin]).all())
        assert (gap == 0).float().mean() > 0.5


def test_camera_kinds_and_substacks():
    """The camera argument the kernel takes for each model, and the level
    records' clamps: `substack_dims` is the shape `level_substack` cuts."""
    for camera, kind in (("radtan", "radtan"), ("pinhole", "pinhole"),
                         ("atan", "atan")):
        cam = silicon_gate.align_camera(camera, "cpu")
        k, fx, fy, cx, cy, params = sparse_align_gn.camera_args(cam)
        assert k == sparse_align_gn.CAMERA_KINDS[kind]
        assert fx is cam.fx and cy is cam.cy
        assert params.shape == (() if kind == "atan" else (5,))
    stack = torch.zeros(5, 480, 768)
    for level in range(5):
        sub = sparse_align.level_substack(stack, level, 480, 752)
        assert tuple(sub.shape[1:]) == sparse_align.substack_dims(
            level, 480, 752, stack.shape[-2:])
