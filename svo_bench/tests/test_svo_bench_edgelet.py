"""The edgelet cell (`tum_fr3_edgelet.replay`): its reader, and its check
on the CPU at a small size (sound: correct; the reference in bfloat16 in
the patch functions' place: not) and on a card at its own size."""

import json
import shutil
from pathlib import Path

import pytest

from svo_bench import cells, run

ROOT = Path(__file__).resolve().parents[2]
CELL = "tum_fr3_edgelet.replay"


def test_sampler_launches_per_frame_reads_the_programs_counter():
    """The counter's growth over the window, per frame; nothing to read
    without frames or without the counter (a program that lacks it)."""
    read = cells.load_reader("sampler_launches_per_frame")
    units = [{}] * 4
    assert read({"units": units, "launches": {
        "sample_patches_kernel": 174, "align_iclk_kernel": 0}}) == 43.5
    assert read({"units": [], "launches": {"sample_patches_kernel": 3}}) \
        is None
    assert read({"units": units, "launches": {}}) is None
    assert read({"units": units, "launches": None}) is None


def test_the_cell_reports_its_metrics():
    cell = cells.find_cell(CELL)
    assert cell.config["camera"]["distortion_coefficients"] == [0.0] * 4
    assert [m["name"] for m in cell.end_to_end] == [
        "frames_per_s", "frame_ms_p95", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "sampler_launches_per_frame", "activities_per_frame.edgelet",
        "idle_share.edgelet"]
    assert cells.load_reader("idle_share.edgelet")(
        {"stretch": {"busy_s": 1.0, "window_s": 20.0}}) == pytest.approx(95.0)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A checkout of the harness with the cell at half fr3's resolution
    (the bootstrap's disparity halved with it) and a check that samples
    the window's first frames.  Two threads: the test processes share the
    host."""
    import torch
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(ROOT / "svo_bench", root / "svo_bench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    path = root / "svo_bench" / "configs" / "tum_fr3_edgelet.json"
    cfg = json.loads(path.read_text())
    cam = cfg["camera"]
    fx, fy, cx, cy = cam["intrinsics"]
    cam["resolution"] = [320, 240]
    cam["intrinsics"] = [fx / 2, fy / 2, (cx + 0.5) / 2 - 0.5,
                         (cy + 0.5) / 2 - 0.5]
    cfg["svo_config"] = {**cfg["svo_config"], "init_min_disparity": 20.0}
    path.write_text(json.dumps(cfg))
    path = root / "svo_bench" / "traffic" / "replay.json"
    mix = json.loads(path.read_text())
    mix["check"] = {"units": 2, "span": 3, "pose_units": 40}
    path.write_text(json.dumps(mix))
    return root


@pytest.mark.parametrize("control", [0, 2])
def test_the_check_holds_the_1d_path(small, control):
    """Sound: correct.  The control in the patch functions' place, the 1D
    loop's samples among them: `sample_gap` fails."""
    res = run.execute(CELL, 2147483659, 0.1, False, device="cpu",
                      control=control, min_units=40, root=small,
                      log=lambda m: None)
    failing = [k for k, c in res["compared"].items()
               if c["value"] is None or c["value"] > c["limit"]]
    assert res["correct"] is (control == 0), failing
    if control:
        assert "sample_gap" in failing


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    """The cell at its own size on the card: a short sound run is correct,
    the control in the patch functions' place is not."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sound = run.execute(CELL, 3000000019, 5.0, False, log=lambda m: None)
    ctl = run.execute(CELL, 3000000019, 5.0, False, control=2,
                      log=lambda m: None)
    assert sound["correct"] and not ctl["correct"]
