"""The port's span and counter recorder (`utils/profiling.py`) on the CPU:
off, it records nothing and enters no profiler range; on, over a few
synthetic frames, the stage spans nest under their unit, every blocking
read of the tracking path is counted, and the spans sit on the profiler's
clock and in `device_trace`'s Chrome trace."""

import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import pipeline
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.ops import sparse_align
from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
from android_svo_tpu_torch.utils import profiling

torch.set_num_threads(1)

PORT = Path(__file__).resolve().parents[1] / "android_svo_tpu_torch"
W, H = 320, 240
# small arenas: a default frame takes about a quarter second here
CFG = SVOConfig(max_n_kfs=4, max_points=512, max_seeds=96,
                ransac_n_trials=64, init_min_disparity=20.0, loba_n_iter=0)
STAGES = ("pyramid_creation", "sparse_img_align", "reproject",
          "pose_optimizer", "point_optimizer", "depth_filter", "keyframe")
# the handler's reads of a tracked frame: the keyframe decision and the six
# results
READS_BEYOND_ALIGN = 1 + 6


@pytest.fixture
def recorder():
    mon = profiling.install()
    yield mon
    profiling.uninstall()


@pytest.fixture(scope="module")
def scene():
    """Frames 0 and 4 bootstrap; frames 5-7 are tracked."""
    cam = synthetic.default_camera(W, H, device="cpu")
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024,
                                 device="cpu")
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i), device="cpu"))
        for i in range(9)]
    return cam, imgs


@pytest.fixture(scope="module")
def tracked(scene):
    """A recorded run: bootstrap, then three tracked frames, the middle one
    with a `perf_mon` on the handler; each frame's read count beside its
    alignment iterations."""
    cam, imgs = scene
    mon = profiling.install()
    try:
        handler = fh.FrameHandler(cam, CFG, device="cpu")
        for img in (imgs[0], imgs[4]):
            handler.add_image(img)
        assert handler.stage == fh.STAGE_DEFAULT_FRAME
        frames = []
        for k, img in enumerate(imgs[5:8]):
            handler.perf_mon = profiling.PerformanceMonitor() if k == 1 \
                else None
            reads0 = mon.counters["host_reads"]
            iters0 = mon.counters["align_iters"]
            res = handler.add_image(img)
            frames.append(dict(
                result=res.result, unit=mon.unit,
                reads=mon.counters["host_reads"] - reads0,
                iters=mon.counters["align_iters"] - iters0,
                align=sum(sparse_align.ITERATIONS)))
        handler.perf_mon = None
    finally:
        profiling.uninstall()
    return mon, frames, handler


def test_off_records_nothing_and_enters_no_range(scene, monkeypatch):
    """No monitor and no profiler: `span` is the shared null context,
    `count` and `host_read` record nothing, and a whole frame enters no
    `record_function`."""
    entered = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: entered.append(name))
    assert profiling.installed() is None and not profiling.profiler_on()
    assert profiling.span("reproject") is profiling.span("keyframe")
    with profiling.span("reproject"):
        profiling.count("host_reads")
        assert profiling.host_read(torch.tensor(3), "result") == 3
    cam, imgs = scene
    handler = fh.FrameHandler(cam, CFG, device="cpu")
    handler.add_image(imgs[0])
    assert entered == []


def _ancestors(spans, i):
    out, p = [], spans[i].parent
    while p >= 0:
        out.append(spans[p].name)
        p = spans[p].parent
    return out


def test_self_time_units_and_nesting(recorder):
    """Self time is a span's duration less its children's; a unit span
    numbers the spans inside it, the spans outside every unit get -1, and
    `total_s` counts nested spans of one name once."""
    with profiling.span("build.x"):
        pass
    for _ in range(2):
        with profiling.span("tot_time"):
            with profiling.span("bootstrap"):
                with profiling.span("bootstrap"):
                    sum(range(20000))
                profiling.count("host_reads", 2)
    spans, own = recorder.spans(), recorder.self_ns()
    assert [(s.name, s.parent, s.unit) for s in spans] == [
        ("build.x", -1, -1), ("tot_time", -1, 0), ("bootstrap", 1, 0),
        ("bootstrap", 2, 0), ("tot_time", -1, 1), ("bootstrap", 4, 1),
        ("bootstrap", 5, 1)]
    dur = [s.end_ns - s.start_ns for s in spans]
    assert own[1] == dur[1] - dur[2] and own[2] == dur[2] - dur[3]
    assert own[3] == dur[3]
    assert recorder.total_s("bootstrap") == (dur[2] + dur[5]) / 1e9
    assert recorder.counters["host_reads"] == 4
    assert recorder.unit_counts == [{"host_reads": 2}, {"host_reads": 2}]
    table = recorder.span_table(units={1})
    assert table["bootstrap"]["spans"] == 2
    assert table["tot_time"]["self_ms_per_unit"] == own[4] / 1e6


def test_stage_spans_nest_under_their_frame(tracked):
    mon, frames, _ = tracked
    spans, own = mon.spans(), mon.self_ns()
    for f in frames:
        assert f["result"] != pipeline.RES_FAILURE
        unit = [i for i, s in enumerate(spans) if s.unit == f["unit"]]
        (top,) = [i for i in unit if spans[i].parent < 0]
        assert spans[top].name == "tot_time"
        names = {spans[i].name for i in unit}
        assert set(STAGES) <= names
        assert {"fused_track_dispatch", "host_read.align_stop",
                "host_read.keyframe", "host_read.result",
                "patch.sample_patches", "patch.epi_scan"} <= names
        for i in unit:
            s = spans[i]
            assert s.start_ns <= s.end_ns and own[i] >= 0
            if i != top:
                p = spans[s.parent]
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
                assert p.unit == f["unit"]
            if s.name in STAGES:       # each stage inside the frame's call
                assert "fused_track_dispatch" in _ancestors(spans, i)
        total = spans[top].end_ns - spans[top].start_ns
        assert sum(own[i] for i in unit) <= total
    table = mon.span_table(units={f["unit"] for f in frames})
    assert table["tot_time"]["spans"] == len(frames)
    assert table["host_read.result"]["spans"] == 6 * len(frames)


def test_every_read_of_a_frame_is_counted(tracked):
    """A tracked frame's reads are its alignment iterations (one read
    each), its keyframe decision and its six results, with or without a
    `perf_mon` on the handler (its own log read is not counted)."""
    mon, frames, _ = tracked
    for f in frames:
        assert f["iters"] == f["align"] > 0
        assert f["reads"] == f["align"] + READS_BEYOND_ALIGN
        assert mon.unit_counts[f["unit"]] == {"host_reads": f["reads"],
                                              "align_iters": f["iters"]}


# edgelets with 1D epipolar alignment; the matching passes and the seed
# update given iteration counts of their own, so the counter tells them
# apart
EDGE_CFG = dataclasses.replace(CFG, edgelet_detection=True,
                               epi_search_1d=True, align_max_iter=8,
                               subpix_n_iter=6)


@pytest.fixture(scope="module")
def tracked_edgelets(scene):
    """Frames 5-7 tracked under `EDGE_CFG` with the recorder on, each
    frame's reads beside its alignment iterations."""
    cam, imgs = scene
    mon = profiling.install()
    try:
        handler = fh.FrameHandler(cam, EDGE_CFG, device="cpu")
        for img in (imgs[0], imgs[4]):
            handler.add_image(img)
        assert handler.stage == fh.STAGE_DEFAULT_FRAME
        frames = []
        for img in imgs[5:8]:
            reads0 = mon.counters["host_reads"]
            res = handler.add_image(img)
            frames.append(dict(result=res.result, unit=mon.unit,
                               reads=mon.counters["host_reads"] - reads0,
                               align=sum(sparse_align.ITERATIONS)))
    finally:
        profiling.uninstall()
    return mon, frames


def _unit_spans(spans, unit, name):
    return [i for i, s in enumerate(spans) if s.unit == unit
            and s.name == name]


def test_align1d_iters_count_the_1d_loop(tracked_edgelets):
    """Under edgelets and `epi_search_1d` each `align1d` span adds its
    loop's iterations: `align_max_iter` in the matching passes (one a
    pass), `subpix_n_iter` in the seed update (one a frame)."""
    mon, frames = tracked_edgelets
    spans = mon.spans()
    for f in frames:
        assert f["result"] != pipeline.RES_FAILURE
        calls = _unit_spans(spans, f["unit"], "align1d")
        stages = ["reproject" if "reproject" in _ancestors(spans, i)
                  else "depth_filter" for i in calls]
        assert stages.count("reproject") == 1 + CFG.reproject_n_retries
        assert stages.count("depth_filter") == 1
        want = sum(EDGE_CFG.align_max_iter if st_ == "reproject"
                   else EDGE_CFG.subpix_n_iter for st_ in stages)
        assert mon.unit_counts[f["unit"]]["align1d_iters"] == want


def test_the_1d_spans_nest_in_their_stages(tracked_edgelets):
    """`align1d` lies inside `reproject` or `depth_filter` and holds one
    sampler call an iteration; `zmssd_accept` lies inside `reproject`,
    one a matching pass."""
    mon, frames = tracked_edgelets
    spans = mon.spans()
    for f in frames:
        for i in _unit_spans(spans, f["unit"], "align1d"):
            up = _ancestors(spans, i)
            assert ("reproject" in up) != ("depth_filter" in up)
            n_iter = (EDGE_CFG.align_max_iter if "reproject" in up
                      else EDGE_CFG.subpix_n_iter)
            kids = [s.name for s in spans if s.parent == i]
            assert kids == ["patch.sample_patches"] * n_iter
        gates = _unit_spans(spans, f["unit"], "zmssd_accept")
        assert len(gates) == 1 + CFG.reproject_n_retries
        assert all("reproject" in _ancestors(spans, i) for i in gates)


def test_the_1d_loop_adds_no_read(tracked_edgelets):
    """An edgelet frame reads what a default frame reads: its alignment
    iterations, its keyframe decision and its six results."""
    mon, frames = tracked_edgelets
    for f in frames:
        assert f["reads"] == f["align"] + READS_BEYOND_ALIGN
        assert mon.unit_counts[f["unit"]]["host_reads"] == f["reads"]


@pytest.fixture(scope="module", params=[True, False],
                ids=["fixed_neighbours", "core_only"])
def tracked_loba(request):
    """Local BA (2 GN iterations) after every keyframe, with and without
    its fixed neighbour keyframes, over 14 tracked frames of a sweep that
    inserts a keyframe every few frames, the recorder on."""
    cfg = dataclasses.replace(CFG, loba_n_iter=2,
                              loba_fix_neighbour_kfs=request.param)
    cam = synthetic.default_camera(W, H, device="cpu")
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024,
                                 device="cpu")
    mon = profiling.install()
    try:
        handler = fh.FrameHandler(cam, cfg, device="cpu")
        for i in [0] + list(range(4, 19)):
            handler.add_image(synthetic.render(tex, cam, synthetic.lookdown_pose(
                0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                            0.004 * i), device="cpu")))
    finally:
        profiling.uninstall()
    assert handler.n_local_ba >= 1
    return mon, handler, cfg


def test_local_ba_spans_nest_in_local_ba(tracked_loba):
    """Each `local_ba` span holds the core choice and compaction
    (`local_ba.select`), then each GN iteration's partial sums, solve and
    update, in that order; no `local_ba.*` span opens outside one."""
    mon, handler, cfg = tracked_loba
    spans = mon.spans()
    calls = [i for i, s in enumerate(spans) if s.name == "local_ba"]
    assert len(calls) == handler.n_local_ba
    for i in calls:
        kids = [s.name for s in spans if s.parent == i]
        assert kids == ["local_ba.select"] + [
            "local_ba.partials", "local_ba.solve",
            "local_ba.update"] * cfg.loba_n_iter
        assert "tot_time" in _ancestors(spans, i)
    inner = [i for i, s in enumerate(spans) if s.name.startswith("local_ba.")]
    assert len(inner) == len(calls) * (1 + 3 * cfg.loba_n_iter)
    assert all(spans[spans[i].parent].name == "local_ba" for i in inner)


def test_local_ba_iters_count_the_gn_iterations(tracked_loba):
    """`local_ba_iters` grows by `loba_n_iter` a local BA call, in the unit
    (frame) that dispatched it, with no read of its own."""
    mon, handler, cfg = tracked_loba
    assert mon.counters["local_ba_iters"] == (cfg.loba_n_iter
                                              * handler.n_local_ba)
    spans = mon.spans()
    ba_units = {s.unit for s in spans if s.name == "local_ba"}
    for u, counts in enumerate(mon.unit_counts):
        want = cfg.loba_n_iter if u in ba_units else 0
        assert counts.get("local_ba_iters", 0) == want, u
        if u in ba_units:
            reads = [s for s in spans if s.unit == u
                     and s.name.startswith("host_read")]
            assert not any("local_ba" in _ancestors(spans, spans.index(r))
                           for r in reads)


def test_bootstrap_and_builds_are_set_up_spans(tracked):
    mon, _, _ = tracked
    boot = [s for s in mon.spans() if s.name == "bootstrap"]
    assert len(boot) == 2 and all(s.parent >= 0 for s in boot)
    assert mon.total_s("bootstrap") == pytest.approx(
        sum(s.end_ns - s.start_ns for s in boot) / 1e9)
    assert mon.total_s("build") == 0.0        # no build on the CPU path


def test_the_batched_step_is_a_unit(tracked, scene):
    """Two copies of the tracked state as a batch of two: one
    `batched_step` unit whose reads are its alignment iterations (one
    `any(active)` read each) and its keyframe decision."""
    _, _, handler = tracked
    _, imgs = scene
    track = make_batched_track(CFG, handler.cam, handler.dims)
    vo_b = st.stack_states([handler.vo, handler.vo])
    mon = profiling.install()
    try:
        track(vo_b, torch.stack([imgs[8], imgs[8]]))
    finally:
        profiling.uninstall()
    spans = mon.spans()
    assert [s.name for s in spans if s.parent < 0] == ["batched_step"]
    assert {s.unit for s in spans} == {0}
    n_iter = sum(sparse_align.ITERATIONS)
    assert mon.counters["align_iters"] == n_iter
    assert mon.counters["host_reads"] == n_iter + 1
    names = [s.name for s in spans]
    assert names.count("host_read.align_active") == n_iter
    # a vmapped patch call is one span (the batched form's): alignment
    # samples once per iteration and once per level for its reference
    align = [i for i, s in enumerate(spans) if s.name == "patch.sample_patches"
             and "sparse_img_align" in _ancestors(spans, i)]
    assert len(align) == n_iter + len(sparse_align.ITERATIONS)


def test_spans_sit_on_the_profiler_clock(tmp_path, recorder):
    """Under the profiler a span also opens a range of its name and is
    recorded inside it: converted through the monitor's clock pair, each
    span lies within its range, their starts a range's entry apart
    (within 100 us, the profile's first range aside), and `device_trace`
    writes the spans into its Chrome trace beside the ranges."""
    with profiling.device_trace(str(tmp_path)) as prof:
        assert profiling.profiler_on()
        for _ in range(5):
            with profiling.span("probe_span"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            profiling.host_read(torch.tensor(1.0), "probe")
    ranges = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe_span")
    spans = [s for s in recorder.spans() if s.name == "probe_span"]
    assert len(ranges) == len(spans) == 5
    gaps = []
    for (r0, r1), s in zip(ranges, spans):
        s0, s1 = recorder.profiler_ns(s.start_ns), recorder.profiler_ns(
            s.end_ns)
        assert r0 - 20_000 <= s0 <= s1 <= r1 + 20_000
        gaps.append(s0 - r0)
    assert sorted(gaps[1:])[1] < 100_000
    trace = json.loads((tmp_path / "trace.json").read_text())
    mine = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["probe_span", "host_read.probe"] * 5
    annotated = sorted((e["ts"], e["dur"]) for e in trace["traceEvents"]
                       if e.get("name") == "probe_span"
                       and e.get("cat") != "program_span")
    for e, (ts, dur) in zip([e for e in mine if e["name"] == "probe_span"],
                            annotated):
        assert ts - 20 <= e["ts"] <= e["ts"] + e["dur"] <= ts + dur + 20


def test_tracking_path_reads_and_ranges_go_through_the_recorder():
    """Outside `utils/profiling.py` the port opens no bare
    `record_function`, and no module of the tracking path calls `.item()`
    itself."""
    for path in PORT.rglob("*.py"):
        rel = path.relative_to(PORT).as_posix()
        text = path.read_text()
        if rel != "utils/profiling.py":
            assert "record_function" not in text, rel
        if rel.startswith(("core/", "ops/", "parallel/", "data/")):
            assert not re.search(r"\.item\(\)", text), rel
