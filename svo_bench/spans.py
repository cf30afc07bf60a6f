"""One cell run with the program's span recorder on and no profiler: the
host self time of every stage, the blocking reads and alignment
iterations per unit, the patch functions' host time per call, and the
set-up spans, all on the host clock the profiler does not inflate.

    python3 -m svo_bench.spans --workload <config>.<traffic> --seed <n> \\
        --seconds <s>

It installs a `PerformanceMonitor` (`android_svo_tpu_torch/utils/
profiling.py`) before the cell is set up and runs the cell as
`svo_bench.run --trace 0` does; that run, with nothing installed, is
the one to set the recorder's cost beside.  The last line of
standard output is the run's result with, under `spans`, the window's
numbers (`window_numbers`) and every span's self time per unit.  Exits 2
without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

STAGES = ("pyramid_creation", "sparse_img_align", "reproject",
          "pose_optimizer", "point_optimizer", "depth_filter", "keyframe")


def window_numbers(mon, n_units: int, unit_name: str, traffic: str) -> dict:
    """The numbers of the monitor's last `n_units` units (the window's:
    the cell's set-up comes first and nothing runs after it), under the
    names of the per-layer metrics they would be (`<quantity>.<traffic>`
    for a quantity split by cell)."""
    units = set(range(mon.unit - n_units + 1, mon.unit + 1))
    table = mon.span_table(units)
    counts = [mon.unit_counts[u] for u in sorted(units)]

    def per_unit(name):
        return sum(c.get(name, 0) for c in counts) / len(counts)

    patch = [row for name, row in table.items() if name.startswith("patch.")]
    n_patch = sum(row["spans"] for row in patch)
    out = {f"host_reads_per_{unit_name}": per_unit("host_reads"),
           f"align_iters_per_{unit_name}": per_unit("align_iters")}
    for stage in ("pose_optimizer", "sparse_img_align"):
        out[f"{stage}_host_ms.{traffic}"] = (
            table[stage]["self_ms_per_unit"] if stage in table else None)
    out[f"patch_host_us.{traffic}"] = (
        1e3 * sum(row["self_ms"] for row in patch) / n_patch
        if n_patch else None)
    out["bootstrap_s"] = mon.total_s("bootstrap")
    out["setup_build_s"] = mon.total_s("build")
    out["units"] = len(units)
    out["stages_ms"] = {s: table[s]["self_ms_per_unit"] for s in STAGES
                        if s in table}
    return out


def measure(workload: str, seed: int, seconds: float, device=None,
            root=None, log=None) -> dict:
    """The cell's result (`run.execute`, untraced), with the recorder
    installed through set-up and window."""
    from android_svo_tpu_torch.utils import profiling
    from svo_bench import cells, drivers, run
    mon = profiling.install()
    try:
        res = run.execute(workload, seed, seconds, False, device=device,
                          root=root, log=log or run._log)
    finally:
        profiling.uninstall()
    cell = cells.find_cell(workload, *(() if root is None else (root,)))
    unit_name = drivers.DRIVERS[cell.traffic["driver"]].unit_name
    n_units = res["attempted"] // int(cell.config["sequences"])
    res["spans"] = {
        **window_numbers(mon, n_units, unit_name, workload.split(".", 1)[1]),
        "table": {k: {"spans": v["spans"],
                      "self_ms_per_unit": v["self_ms_per_unit"]}
                  for k, v in mon.span_table().items()}}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("svo_bench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    res = measure(args.workload, args.seed, args.seconds)
    res.pop("compared", None)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
