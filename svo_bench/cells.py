"""What a cell is made of, found by name: `BENCHMARK.json` at the root of
the checkout names the cell (`<config>.<traffic>`), its configuration
(`svo_bench/configs/<config>.json`), its traffic mix
(`svo_bench/traffic/<traffic>.json`), its end-to-end metrics and the
per-layer metrics it reports, each read by `svo_bench/metrics/<name>.py`
(or, for `<quantity>.<cells>`, by `<quantity>.py`).
A later cell, mix or metric is added as files and an entry, with no edit
here."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def bench_dir(root: Path = ROOT) -> Path:
    return Path(root) / BENCH_DIR.name


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root's BENCHMARK.json with its configuration and
    traffic files read and the metrics it reports listed; raises KeyError
    for a cell the file does not name."""
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    folder = bench_dir(root)
    with open(folder / "configs" / f"{entry['config']}.json") as f:
        config = json.load(f)
    with open(folder / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in e2e_names and _reports(m, name)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """`svo_bench/metrics/<metric>.py`, or for a metric named
    `<quantity>.<cells>` that has no file of its own, the quantity's
    reader `svo_bench/metrics/<quantity>.py`: one reader serves every
    split of a quantity by the end-to-end metric it moves."""
    folder = bench_dir(root) / "metrics"
    own = folder / f"{metric}.py"
    return own if own.exists() else folder / f"{metric.split('.')[0]}.py"


def load_reader(metric: str, root: Path = ROOT):
    """The `read(ctx)` function of the metric's reader (`reader_path`)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        "svo_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
