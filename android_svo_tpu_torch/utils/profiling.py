"""Per-stage timing instrumentation — port of
`android_svo_tpu/utils/profiling.py`.

`PerformanceMonitor` keeps the reference's ten timer names
(`frame_handler_base.cpp:46-55`), host wall-clock timers that also open a
`torch.profiler.record_function` range (so a profiler trace shows them), and
writes one JSONL record per frame with the same keys as the JAX package's
monitor: `t_<timer>` for every timer that ran, then the logged values.

A host timer around work that is only dispatched to the card (local BA, the
tracking step before its scalar read) measures the dispatch; device time per
stage comes from `device_trace` (`torch.profiler`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# ref frame_handler_base.cpp:46-55
REFERENCE_TIMERS = (
    "pyramid_creation", "sparse_img_align", "reproject", "reproject_kfs",
    "reproject_candidates", "feature_align", "pose_optimizer",
    "point_optimizer", "local_ba", "tot_time",
)


class PerformanceMonitor:
    """Named host-side timers + per-frame log channels, JSONL trace output."""

    def __init__(self, trace_path: str | None = None):
        self.trace_path = trace_path
        self._file = open(trace_path, "w") if trace_path else None
        self.timers: dict[str, float] = {}
        self.logs: dict[str, object] = {}
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        for name in REFERENCE_TIMERS:
            self.add_timer(name)

    def add_timer(self, name: str) -> None:
        self.timers.setdefault(name, 0.0)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Host wall-clock timer + profiler range."""
        with record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.timers[name] = dt
                self.totals[name] += dt
                self.counts[name] += 1

    def log(self, name: str, value) -> None:
        self.logs[name] = value

    def write_frame(self) -> None:
        """Flush one frame's timers and logs as one JSON line."""
        if self._file is None:
            return
        rec = {**{f"t_{k}": v for k, v in self.timers.items() if v > 0},
               **self.logs}
        self._file.write(json.dumps(rec) + "\n")
        self.timers = {k: 0.0 for k in self.timers}
        self.logs = {}

    def summary(self) -> dict:
        return {k: {"total_s": self.totals[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
                    "count": self.counts[k]}
                for k in self.totals}

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with `torch.profiler` (host and, where a card is
    present, device activity) and write a Chrome trace to
    `logdir/trace.json`; yields the profiler."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_DISPATCH_RANGE = "dispatch_counts"


def dispatch_counts(fn) -> tuple[int, int]:
    """(ATen ops, device activities) of one call of `fn` under
    `torch.profiler`: the ATen ops `fn` dispatches itself (those directly
    inside its range, not the ops they call in turn; a port custom op,
    `svo_torch::*`, is looked through, and the ATen ops directly inside it
    count as `fn`'s own) and the kernels, copies and sets it puts on the
    card.  The card is synchronised before the profile closes, where there
    is one."""
    from torch.autograd import DeviceType
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(_DISPATCH_RANGE):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def own(e):
        p = e.cpu_parent
        if p is not None and p.name.startswith("svo_torch::"):
            p = p.cpu_parent
        return p is not None and p.name == _DISPATCH_RANGE

    n_ops = n_dev = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_dev += e.name != _DISPATCH_RANGE   # the range's own device span
        elif e.name.startswith("aten::") and own(e):
            n_ops += 1
    return n_ops, n_dev


def device_time_us(evt) -> float:
    """A profiler event's device time in microseconds (the attribute's name
    differs between torch versions)."""
    if hasattr(evt, "device_time_total"):
        return float(evt.device_time_total)
    return float(evt.cuda_time_total)


def device_ms(fn, symbol: str, iters: int = 20):
    """Device ms per launch of the kernels whose name holds `symbol`, over
    `iters` calls of `fn` under `torch.profiler` (after one call outside
    it); None when the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if symbol in evt.key:
            total_us += device_time_us(evt)
            count += evt.count
    return total_us / count / 1e3 if count and total_us > 0 else None
