"""Pose refinement's dispatch (`ops/pose_gn.py`) on the CPU: on CPU
tensors, or with `use_pallas` off, `optimize_pose` runs the plain version
and launches nothing; the op's vmap rule gives a loop of single calls bit
for bit; the benchmark's `PoseProbe` still sees one call a frame and one a
sequence of a batched step.  The kernel itself is held against the plain
version on the card (`tests/test_torch_cuda.py`)."""

import pytest
import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import pipeline, pose_opt
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.ops import pose_gn
from android_svo_tpu_torch.parallel.multi_seq import make_batched_track

torch.set_num_threads(1)


def _scene(seed, n=96):
    """n points ahead of an identity start, seen from a pose a small twist
    away as noisy bearings, a tenth of them outliers, a fifth invalid."""
    g = torch.Generator().manual_seed(seed)
    p_w = torch.randn(n, 3, generator=g) + torch.tensor([0.0, 0.0, 4.0])
    xyz = SE3.exp(torch.randn(6, generator=g) * 0.03).apply(p_w)
    f = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    f = f + torch.randn(n, 3, generator=g) * 0.0015
    out = torch.rand(n, generator=g) < 0.1
    f = torch.where(out[:, None], f + torch.randn(n, 3, generator=g) * 0.05,
                    f)
    level = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) < 0.8
    T0 = SE3(q=torch.tensor([1.0, 0.0, 0.0, 0.0]), t=torch.zeros(3))
    return T0, p_w, f, level, valid, torch.tensor(458.654)


def _flat(out):
    return (out[0].q, out[0].t, *out[1:])


@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_cpu_runs_the_plain_version(method, use_pallas):
    """CPU tensors (with the kernels allowed or not) take the plain
    version: its outputs bit for bit, and no launch."""
    cfg = SVOConfig(poseoptim_method=method, use_pallas=use_pallas)
    args = _scene(1)
    pose_gn.reset_launch_counts()
    got = pose_opt.optimize_pose(*args, cfg)
    want = pose_opt.optimize_pose_plain(
        *args, cfg.poseoptim_n_iter, cfg.poseoptim_thresh, method == "lm")
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == 0
    assert int(got[2]) > 0
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("method,n_iter", [("gn", 10), ("lm", 10),
                                           ("gn", 3), ("gn", 0)])
def test_vmap_rule_equals_single_calls(method, n_iter):
    """torch.func.vmap over optimize_pose goes through the op's vmap rule
    (`svo_torch::pose_gn`), focal shared: on the CPU each sequence's
    outputs equal its own call bit for bit (with no iteration the start,
    copied: an op returns no input)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = SVOConfig(poseoptim_method=method, poseoptim_n_iter=n_iter)
    scenes = [_scene(s) for s in range(3)]
    q = torch.stack([s[0].q for s in scenes])
    t = torch.stack([s[0].t for s in scenes]) + 0.01
    rows = [torch.stack([s[i] for s in scenes]) for i in range(1, 5)]
    focal = scenes[0][5]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = torch.func.vmap(lambda q, t, *r: pose_opt.optimize_pose(
            SE3(q=q, t=t), *r, focal, cfg))(q, t, *rows)
    assert "svo_torch::pose_gn" in {e.name for e in prof.events()}
    for b in range(3):
        single = pose_opt.optimize_pose(SE3(q=q[b], t=t[b]),
                                        *(r[b] for r in rows), focal, cfg)
        for o, s in zip(_flat(out), _flat(single)):
            assert torch.equal(o[b], s), b
    if n_iter == 0:
        assert torch.equal(out[0].q, q)
        assert out[0].q.data_ptr() != q.data_ptr()


# small arenas, as tests/test_torch_tracing.py's
CFG = SVOConfig(max_n_kfs=4, max_points=512, max_seeds=96,
                ransac_n_trials=64, init_min_disparity=20.0, loba_n_iter=0)


@pytest.fixture(scope="module")
def handler():
    """A handler bootstrapped on frames 0 and 4 of a synthetic sweep, and
    frames 5-6 to track."""
    cam = synthetic.default_camera(320, 240, device="cpu")
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024,
                                 device="cpu")
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i), device="cpu"))
        for i in range(7)]
    h = fh.FrameHandler(cam, CFG, device="cpu")
    for img in (imgs[0], imgs[4]):
        h.add_image(img)
    assert h.stage == fh.STAGE_DEFAULT_FRAME
    return h, imgs


def test_pose_probe_sees_each_frame_and_sequence(handler):
    """The benchmark's `PoseProbe` wraps `core/pipeline.py`'s module-level
    `optimize_pose`: through the new dispatch it records one call for a
    tracked frame and, for a batched step of two sequences (the op's vmap
    rule), one a sequence, each with the refined pose it returned."""
    from svo_bench import probe
    h, imgs = handler
    pp = probe.PoseProbe(pipeline).install()
    try:
        pp.capture = True
        res = h.add_image(imgs[5])
        assert res.result != pipeline.RES_FAILURE
        assert len(pp.calls) == 1
        rec = pp.calls[0]
        assert rec["q"].shape == (4,) and rec["t"].shape == (3,)
        assert rec["p_w"].shape == (h.dims["C"], 3)
        assert rec["n_iter"] == CFG.poseoptim_n_iter
        track = make_batched_track(CFG, h.cam, h.dims)
        vo_b = st.stack_states([h.vo, h.vo])
        track(vo_b, torch.stack([imgs[6], imgs[6]]))
        assert len(pp.calls) == 3
        a, b = pp.calls[1:]
        for key in ("q0", "t0", "p_w", "valid", "q", "t"):
            assert a[key].shape == rec[key].shape
            assert torch.equal(a[key], b[key]), key
    finally:
        pp.remove()
    assert pipeline.optimize_pose is pose_opt.optimize_pose
