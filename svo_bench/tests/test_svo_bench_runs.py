"""Runs of the harness: it refuses to run without a card or without the
program beside it; on the CPU, at a small size, the check comes out true
for a sound run and false for the control in the patch functions' place
and for each fault planted in the timed path; on a card, the cells
themselves."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from svo_bench import run

ROOT = Path(__file__).resolve().parents[2]
CMD = [sys.executable, "-m", "svo_bench.run", "--seed", "2147483659",
       "--seconds", "1", "--trace", "0", "--workload"]


def _no_card_env():
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_run_refuses_without_a_card():
    p = subprocess.run(CMD + ["euroc_mh01_noloba.replay"], cwd=ROOT,
                       capture_output=True, text=True, env=_no_card_env(),
                       timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_fails_with_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and the harness: no program
    to measure, no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "svo_bench", tmp_path / "svo_bench")
    p = subprocess.run(CMD + ["euroc_11seq.batch11"], cwd=tmp_path,
                       capture_output=True, text=True, env=_no_card_env(),
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A checkout of the harness with the two cells at half EuRoC's
    resolution (the bootstrap's disparity halved with it), 3 sequences in
    the batch and a check that samples the window's first units.  Two
    threads a worker: the test processes share the host."""
    import torch
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(ROOT / "svo_bench", root / "svo_bench")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in b["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cam = cfg["camera"]
        fx, fy, cx, cy = cam["intrinsics"]
        cam["resolution"] = [376, 240]
        cam["intrinsics"] = [fx / 2, fy / 2, (cx + 0.5) / 2 - 0.5,
                             (cy + 0.5) / 2 - 0.5]
        cfg["svo_config"] = {**cfg.get("svo_config", {}),
                             "init_min_disparity": 20.0}
        cfg["sequences"] = min(cfg["sequences"], 3)
        path.write_text(json.dumps(cfg))
    for path in (root / "svo_bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["check"] = {"units": 2, "span": 3, "pose_units": 40}
        path.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


CASES = [("euroc_mh01_noloba.replay", None), ("euroc_mh01_noloba.replay", "frozen_step"),
         ("euroc_mh01_noloba.replay", "altered_pose"),
         ("euroc_mh01_noloba.replay", "altered_kernel"),
         ("euroc_mh01_noloba.replay", "control"),
         ("euroc_11seq.batch11", None), ("euroc_11seq.batch11", "frozen_step"),
         ("euroc_11seq.batch11", "half_batch"),
         ("euroc_11seq.batch11", "altered_kernel")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_the_check_catches_each_fault(small, cell, fault):
    """Sound: correct.  The control (the reference in bfloat16 in the patch
    functions' place), a step that returns its state unchanged, half the
    batch left out, and an answer altered where it is produced (a pose, a
    patch function's rows): not correct.  One chip, so no exchange between
    chips to leave out."""
    faults = () if fault in (None, "control") else (fault,)
    res = run.execute(cell, 2147483659, 0.1, False, device="cpu",
                      control=2 if fault == "control" else 0, faults=faults,
                      min_units=40, root=small, log=lambda m: None)
    failing = [k for k, c in res["compared"].items()
               if c["value"] is None or c["value"] > c["limit"]]
    assert res["correct"] is (fault is None), (fault, failing)
    if fault in ("control", "altered_kernel"):
        assert {"sample_gap", "iclk_uv_gap_px"} & set(failing)
    elif fault is not None:
        assert "ate_m" in failing


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["euroc_mh01_noloba.replay", "euroc_11seq.batch11"])
def test_the_control_fails_on_the_card(cell):
    """The cell at its own size on the card: a short sound run is correct,
    the control in the patch functions' place is not."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sound = run.execute(cell, 3000000019, 5.0, False, log=lambda m: None)
    ctl = run.execute(cell, 3000000019, 5.0, False, control=2,
                      log=lambda m: None)
    assert sound["correct"] and not ctl["correct"]
