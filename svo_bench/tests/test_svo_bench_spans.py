"""`svo_bench.spans`: a cell run with the program's span recorder on, on
the CPU at a small size: the window's reads per unit are its alignment
iterations and the handler's (or the batch's) fixed reads, the set-up
spans are caught, and the run's result is the untraced run's."""

import json
import shutil
from pathlib import Path

import pytest

from svo_bench import spans

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The two cells at half EuRoC's resolution, 2 sequences in the batch
    (as `test_svo_bench_runs.py`'s fixture cuts them)."""
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
        cfg["sequences"] = min(cfg["sequences"], 2)
        path.write_text(json.dumps(cfg))
    for path in (root / "svo_bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["check"] = {"units": 2, "span": 3, "pose_units": 10}
        path.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


@pytest.mark.parametrize("cell,unit,fixed", [
    ("euroc_mh01_noloba.replay", "frame", 1 + 6),
    ("euroc_11seq.batch11", "step", 1)])
def test_the_window_numbers(small, cell, unit, fixed):
    from android_svo_tpu_torch.utils import profiling
    res = spans.measure(cell, 2147483659, 0.1, device="cpu",
                        root=small, log=lambda m: None)
    assert profiling.installed() is None
    got = res["spans"]
    assert got["units"] == res["attempted"] // (2 if unit == "step" else 1)
    assert got[f"align_iters_per_{unit}"] > 0
    assert got[f"host_reads_per_{unit}"] == pytest.approx(
        got[f"align_iters_per_{unit}"] + fixed)
    assert got["bootstrap_s"] > 0 and got["setup_build_s"] >= 0
    name = "replay" if unit == "frame" else "batch11"
    for key in ("pose_optimizer_host_ms", "sparse_img_align_host_ms",
                "patch_host_us"):
        assert got[f"{key}.{name}"] > 0
    assert set(spans.STAGES) == set(got["stages_ms"])
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "compared"}
