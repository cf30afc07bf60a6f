"""Structure optimisation's dispatch (`ops/point_gn.py`) on the CPU: on CPU
tensors, or with `use_pallas` off, `optimize_structure` runs the plain
version and launches nothing; the op's vmap rule gives a loop of single
calls bit for bit; the tracking step's `point_optimizer` stage gives what
the stage gave before it became one op.  The kernel itself is held against
the plain version on the card (`tests/test_torch_cuda.py`)."""

import pytest
import torch

from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import pipeline, point_opt
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.core.scatter import set_rows
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.ops import point_gn, silicon_gate
from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
from android_svo_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _cfg(method="gn", **kw):
    """The path's structure shapes on a small arena."""
    return silicon_gate.point_config(method, max_points=512, **kw)


def _scene(seed, cfg):
    return silicon_gate.point_inputs(seed, cfg, device="cpu")


@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_cpu_runs_the_plain_version(method, use_pallas):
    """CPU tensors (with the kernels allowed or not) take the plain
    version: its outputs bit for bit, the selected landmarks moved and
    stamped, the others untouched, and no launch."""
    cfg = _cfg(method, use_pallas=use_pallas)
    points, kfs, frame_id = _scene(1, cfg)
    point_gn.reset_launch_counts()
    got = point_opt.optimize_structure(points, kfs, frame_id, cfg)
    args = silicon_gate.point_operands(points, kfs, frame_id, cfg)
    pos, last_optim = point_opt.optimize_selected_plain(
        *args, cfg.structureoptim_n_iter, method == "lm")
    assert point_gn.LAUNCHES["point_gn_kernel"] == 0
    assert torch.equal(got.pos, pos) and torch.equal(got.last_optim,
                                                     last_optim)
    slots, sel = args[7], args[8]
    rows = slots[sel]
    assert rows.numel() == cfg.structureoptim_max_pts
    assert bool((got.last_optim[rows] == frame_id).all())
    assert bool((got.pos[rows] != points.pos[rows]).any(-1).any())
    rest = torch.ones(points.pos.shape[0], dtype=torch.bool)
    rest[rows] = False
    assert torch.equal(got.pos[rest], points.pos[rest])
    assert torch.equal(got.last_optim[rest], points.last_optim[rest])
    assert got.obs_f is points.obs_f


@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("n_iter", [0, 1, 5])
def test_vmap_rule_equals_single_calls(method, n_iter):
    """torch.func.vmap over optimize_structure goes through the op's vmap
    rule (`svo_torch::point_gn`): on the CPU each sequence's arena equals
    its own call bit for bit (with no iteration the arena itself, copied:
    an op returns no input)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = _cfg(method, structureoptim_n_iter=n_iter)
    scenes = [_scene(10 + s, cfg) for s in range(3)]
    stacked = [st.stack_states([sc[i] for sc in scenes])
               for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = torch.func.vmap(lambda p, k, f: point_opt.optimize_structure(
            p, k, f, cfg))(*stacked)
    assert "svo_torch::point_gn" in {e.name for e in prof.events()}
    for b, sc in enumerate(scenes):
        one = point_opt.optimize_structure(*sc, cfg)
        assert torch.equal(out.pos[b], one.pos), b
        assert torch.equal(out.last_optim[b], one.last_optim), b
    if n_iter == 0:
        assert torch.equal(out.pos, stacked[0].pos)
        assert out.pos.data_ptr() != stacked[0].pos.data_ptr()


def test_the_wrapper_runs_on_cuda_tensors_only():
    """The kernel's wrapper refuses CPU tensors before any launch (the
    stage never hands it any: `on_card`), and a negative iteration
    count."""
    cfg = _cfg()
    args = silicon_gate.point_operands(*_scene(2, cfg), cfg)
    point_gn.reset_launch_counts()
    with pytest.raises(ValueError):
        point_gn.point_gn(*args, 5, False)
    with pytest.raises(ValueError):
        point_gn.point_gn(*args, -1, False)
    with pytest.raises(TypeError):
        point_gn.point_gn(args[0].numpy(), *args[1:], 5, False)
    assert point_gn.LAUNCHES["point_gn_kernel"] == 0


def _stage_before(vo, cfg):
    """The `point_optimizer` stage as `core/pipeline.py` wrote it before it
    became `optimize_structure`: the selection, the gathers,
    `optimize_points` and the two `set_rows`."""
    pts = vo.points
    slots, sel = point_opt.select_points_for_optim(
        pts.last_optim, pts.valid & (pts.obs_count >= 2),
        cfg.structureoptim_max_pts)
    obs_kf = pts.obs_kf[slots]
    ks = torch.clamp(obs_kf, min=0).to(torch.int64)
    obs_ok = (obs_kf >= 0) & vo.kfs.valid[ks]
    pos_new, _ = point_opt.optimize_points(
        pts.pos[slots], vo.kfs.q_kw[ks], vo.kfs.t_kw[ks], pts.obs_f[slots],
        obs_ok, sel, cfg.structureoptim_n_iter,
        method=cfg.structureoptim_method)
    return (set_rows(pts.pos, slots, torch.where(sel[:, None], pos_new,
                                                 pts.pos[slots])),
            set_rows(pts.last_optim, slots, torch.where(
                sel, vo.frame_id, pts.last_optim[slots])))


# small arenas, as tests/test_torch_tracing.py's
TRACK_CFG = silicon_gate.point_config(
    max_n_kfs=4, max_points=512, max_seeds=96, ransac_n_trials=64,
    init_min_disparity=20.0, loba_n_iter=0)


@pytest.fixture(scope="module")
def handler():
    """A handler bootstrapped on frames 0 and 4 of a synthetic sweep, and
    frames 5-8 to track."""
    cam = synthetic.default_camera(320, 240, device="cpu")
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024,
                                 device="cpu")
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i), device="cpu"))
        for i in range(9)]
    h = fh.FrameHandler(cam, TRACK_CFG, device="cpu")
    for img in (imgs[0], imgs[4]):
        h.add_image(img)
    assert h.stage == fh.STAGE_DEFAULT_FRAME
    return h, imgs


def test_tracking_stage_gives_what_it_gave_before(handler, monkeypatch):
    """On a CPU track of three frames and a batched step of two sequences,
    the `point_optimizer` stage's arena equals the stage as it was written
    before (`_stage_before`) bit for bit, with landmarks selected and
    moved; the batched step calls it once (the op's vmap rule), and no
    kernel launches."""
    h, imgs = handler
    calls = []
    orig = pipeline.optimize_structure

    def checked(points, kfs, frame_id, cfg):
        out = orig(points, kfs, frame_id, cfg)
        if torch._C._functorch.maybe_current_level() is None:
            vo = st.VOState(kfs=kfs, points=points, seeds=None, last=None,
                            frame_id=frame_id, kf_batch=None,
                            next_point_slot=None, pose_cov=None)
            pos, last_optim = _stage_before(vo, cfg)
            assert torch.equal(out.pos, pos)
            assert torch.equal(out.last_optim, last_optim)
            calls.append(int((out.last_optim == frame_id).sum()))
        else:
            calls.append("batched")
        return out

    monkeypatch.setattr(pipeline, "optimize_structure", checked)
    point_gn.reset_launch_counts()
    mon = profiling.install()
    try:
        for img in imgs[5:8]:
            assert h.add_image(img).result != pipeline.RES_FAILURE
    finally:
        profiling.uninstall()
    assert len(calls) == 3 and all(n > 0 for n in calls), calls
    assert "point_gn_launches" not in mon.counters
    track = make_batched_track(TRACK_CFG, h.cam, h.dims)
    track(st.stack_states([h.vo, h.vo]), torch.stack([imgs[8], imgs[8]]))
    assert calls[3:] == ["batched"]
    assert point_gn.LAUNCHES["point_gn_kernel"] == 0


def test_least_time_of_the_point_kernel():
    """point_bound at the path's shapes: the arena's two arrays copied
    (32 bytes a row) dominate the bytes; a batch multiplies both."""
    shapes = silicon_gate.POINT_SHAPES
    args = (shapes["points"], shapes["obs"], shapes["n_iter"],
            shapes["select"])
    ms, by, n_bytes, flops = silicon_gate.point_bound(*args)
    assert by == "bytes"
    assert n_bytes == 8192 * 32 + 20 * (21 + 8 * 45) + 4
    assert flops == 20 * (5 * (135 * 8 + 40) + 30 * 8)
    assert round(ms, 6) == 0.000081
    batched = silicon_gate.point_bound(*args, batch=11)
    assert batched[2:] == (11 * n_bytes, 11 * flops)


def _short(*args):
    """One iteration fewer than asked."""
    return point_opt.optimize_selected_plain(*args[:10], max(args[10] - 1, 0),
                                             args[11])


def _drop(*args):
    """Each landmark of three or more observations loses its last."""
    args = list(args)
    obs_kf = args[2].clone()
    filled = (obs_kf >= 0).sum(-1)
    rows = torch.arange(obs_kf.shape[0])
    last = (filled - 1).clamp(min=0)
    obs_kf[rows, last] = torch.where(filled > 2, -1, obs_kf[rows, last])
    args[2] = obs_kf
    return point_opt.optimize_selected_plain(*args)


def _undamped(*args):
    """LM run as GN: mu left out."""
    return point_opt.optimize_selected_plain(*args[:11], False)


@pytest.mark.parametrize("method", ["gn", "lm"])
def test_compare_points_passes_the_plain_version(method, monkeypatch):
    """`silicon_gate.compare_points` with the plain float32 version in the
    kernel's place passes: its costs are one end of the allowed range."""
    monkeypatch.setattr(point_gn, "point_gn",
                        point_opt.optimize_selected_plain)
    cfg = _cfg(method)
    for seed in (1, 2):
        args = silicon_gate.point_operands(*_scene(seed, cfg), cfg)
        detail, failures = silicon_gate.compare_points(
            args, cfg.structureoptim_n_iter, method == "lm")
        assert not failures, failures
        assert detail["above"] <= 0 and detail["below"] <= 0
        assert detail["risen"] <= 0


@pytest.mark.parametrize("fault,method", [
    ("drop", "gn"), ("drop", "lm"), ("short", "gn"), ("short", "lm"),
    ("undamped", "lm")])
def test_compare_points_catches_faults(fault, method, monkeypatch):
    """Controls: a version that loses an observation, stops one iteration
    short, or leaves LM's damping out, put in the kernel's place, fails
    `compare_points` on every seed of a scene with 30% gross outliers
    (where five iterations do not yet converge every landmark)."""
    monkeypatch.setattr(point_gn, "point_gn", {
        "drop": _drop, "short": _short, "undamped": _undamped}[fault])
    cfg = _cfg(method)
    for seed in (2, 3, 4):
        args = silicon_gate.point_operands(*silicon_gate.point_inputs(
            seed, cfg, outliers=0.3, device="cpu"), cfg)
        _, failures = silicon_gate.compare_points(
            args, cfg.structureoptim_n_iter, method == "lm")
        assert failures, seed
