"""The benchmark's own files, checked without running the program: what
they import, BENCHMARK.json against the contract's limits, and that a
configuration, a traffic mix and a metric are found by name, also when
added as files alone."""

import ast
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

from svo_bench import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "svo_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _imports(path: Path) -> set:
    """Top-level names of the modules a file imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_harness(path):
    """No module the harness runs imports JAX, its packages, the JAX
    package or the scripts beside it; names compared whole, so the port
    (`android_svo_tpu_torch`) passes and `android_svo_tpu` does not."""
    bad = {"jax", "jaxlib", "flax", "android_svo_tpu", "bench", "chip_smoke"}
    assert not _imports(path) & bad
    if "reference" in path.parts:
        assert "android_svo_tpu_torch" not in _imports(path)


def test_whole_name_comparison(monkeypatch):
    """The run's look at sys.modules compares top-level names whole."""
    import types
    from svo_bench.run import forbidden_modules
    monkeypatch.setitem(sys.modules, "android_svo_tpu_torch.probe_name",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "android_svo_tpu.core",
                        types.ModuleType("x"))
    assert forbidden_modules() == ["android_svo_tpu"]


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["svo_bench"] and 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("svo_bench/") and (ROOT / c["file"]).exists()
        data = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(data["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    names = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["name"])
        names.add(w["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert set(m.get("workloads", names)) <= names
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                               names))
    for cell in names:
        got = cells.find_cell(cell)
        assert any(m["name"] != "setup_s" for m in got.end_to_end)
        assert got.per_layer, cell
        for m in got.end_to_end + got.per_layer:
            assert cells.reader_path(m["name"]).exists()
            assert callable(cells.load_reader(m["name"]))
        assert (BENCH / "limits" / f"{cell}.json").exists()
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_added_as_files_alone(tmp_path):
    """A configuration, a traffic mix and a metric added as new files (and
    their entries in BENCHMARK.json) are found by name, with no edit to a
    file of the harness."""
    shutil.copytree(BENCH, tmp_path / "svo_bench")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "euroc_mh01_noloba.json").read_text())
    cfg["camera"]["resolution"] = [640, 480]
    (tmp_path / "svo_bench/configs/tum_fr3.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "replay.json").read_text())
    mix["lap_frames"] = 90
    (tmp_path / "svo_bench/traffic/fast.json").write_text(json.dumps(mix))
    (tmp_path / "svo_bench/metrics/window_units.py").write_text(
        "def read(ctx):\n    return len(ctx['units'])\n")
    (tmp_path / "svo_bench/limits/tum_fr3.fast.json").write_text(
        (BENCH / "limits/euroc_mh01_noloba.replay.json").read_text())
    b["configs"].append({"name": "tum_fr3", "source": "x",
                         "file": "svo_bench/configs/tum_fr3.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tum_fr3.fast", "config": "tum_fr3",
                           "traffic": "fast", "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("tum_fr3.fast")
    b["per_layer"].append({"name": "window_units", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "data", "moves": "frames_per_s",
                           "workloads": ["tum_fr3.fast"]})
    # a split of a quantity that has a reader needs no file of its own
    b["per_layer"].append({"name": "idle_share.fast", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "frames_per_s",
                           "workloads": ["tum_fr3.fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.find_cell("tum_fr3.fast", tmp_path)
    assert cell.config["camera"]["resolution"] == [640, 480]
    assert cell.traffic["lap_frames"] == 90
    assert [m["name"] for m in cell.per_layer] == ["window_units",
                                                   "idle_share.fast"]
    assert cells.load_reader("window_units", tmp_path)({"units": [1, 2]}) == 2
    assert cells.load_reader("idle_share.fast", tmp_path)(
        {"stretch": {"busy_s": 1.0, "window_s": 4.0}}) == 75.0
    with pytest.raises(KeyError):
        cells.find_cell("tum_fr3.fast")
