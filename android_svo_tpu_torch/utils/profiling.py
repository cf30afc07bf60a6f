"""The port's host spans and counters, the per-frame timers, and device
tracing — port of `android_svo_tpu/utils/profiling.py`.

`PerformanceMonitor` is the one recorder.  The program marks its layer
boundaries with `span(name)`; with a monitor installed (`install`) each
span is recorded in memory: its name, its start and end on
`time.perf_counter_ns()`, the index of its parent span and the unit it
belongs to (one frame of `FrameHandler.add_image`, span `tot_time`, or one
batched step, span `batched_step`: the spans of one unit share its
number).  The spans the program opens:

  tot_time, batched_step       the units
  pyramid_creation, sparse_img_align, reproject, pose_optimizer,
  point_optimizer, depth_filter, keyframe
                               the stages of the tracking step
                               (`core/pipeline.py`, `parallel/multi_seq.py`)
  fused_track_dispatch, local_ba
                               the handler's tracking call and its local BA
                               dispatch (`core/frame_handler.py`)
  local_ba.select, local_ba.partials, local_ba.solve, local_ba.update
                               inside `local_ba`: the core choice and the
                               landmarks' compaction, then each GN
                               iteration's partial sums, reduced solve and
                               update (`parallel/ba.py`)
  host_read.<site>             one blocking device-to-host read
                               (`host_read`): align_stop, align_active
                               (the plain alignment loop, on the CPU),
                               keyframe, result, bootstrap, reloc
  patch.<function>             one patch-function call, around the body that
                               launches its kernel (`ops/patch_kernels.py`)
  align1d, zmssd_accept        the 1D alignment loop (`align1d_stack`) and
                               the separate appearance gate of a routed
                               match (`_zmssd_accept`) in `ops/matcher.py`:
                               with edgelets or `epi_search_1d`, inside
                               `reproject` and `depth_filter`
  bootstrap                    the handler's first and second frame and the
                               map built from them
  build.cuda_kernels, build.native_feeder
                               the kernel library's digest and load (or
                               compile), the feeder's `make`

`count(name)` adds to the installed monitor's `counters`: `host_reads`
(every read through `host_read`), `align_iters` (the plain sparse
alignment loop's Gauss-Newton iterations), `align_launches` (launches of
`sparse_align_kernel`, which runs the loop on the card: one a frame or a
batched step), `point_gn_launches` (launches of `point_gn_kernel`, the
`point_optimizer` stage on the card: one a frame or a batched step),
`align1d_iters` (the 1D alignment's iterations, `n_iter`
a call) and `local_ba_iters` (local BA's GN iterations, `loba_n_iter` a
call); `unit_counts` keeps each unit's share.  Counters
count only while a monitor is installed, and the monitor's own reads are
not among them.

With the torch profiler running, each span also opens a `record_function`
range of the same name, so a profiler trace names the stages as before.
With neither a monitor nor the profiler, `span` returns a shared null
context after one check, `count` does nothing and `host_read` is the read
alone: no `record_function` is entered.

Clock: `install` takes one `(perf_counter_ns, time_ns)` pair; the profiler
(Kineto) stamps its events in Unix-epoch nanoseconds, so
`PerformanceMonitor.profiler_ns` lays a span beside the device trace, and
`device_trace` writes the installed monitor's spans into the Chrome trace
it exports.

The per-frame timers stay as the reference has them: `timer` (a span plus
the timer's seconds) under the reference's ten timer names
(`frame_handler_base.cpp:46-55`), `log`, and `write_frame`, one JSONL
record per frame with the JAX package's keys: `t_<timer>` for every timer
that ran, then the logged values.  A host timer around work that is only
dispatched to the card (local BA) measures the dispatch; device time per
stage comes from `device_trace`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# ref frame_handler_base.cpp:46-55
REFERENCE_TIMERS = (
    "pyramid_creation", "sparse_img_align", "reproject", "reproject_kfs",
    "reproject_candidates", "feature_align", "pose_optimizer",
    "point_optimizer", "local_ba", "tot_time",
)

# a span of one of these names opens a unit (a frame, a batched step)
UNIT_SPANS = frozenset({"tot_time", "batched_step"})

_NULL = contextlib.nullcontext()
_installed = None


def profiler_on() -> bool:
    """Whether a torch profiler is running (the profiler's own state, which
    every way of starting it sets)."""
    return torch.autograd._profiler_enabled()


class Span(NamedTuple):
    name: str
    start_ns: int         # time.perf_counter_ns()
    end_ns: int
    parent: int           # index of the enclosing span, -1 at the top
    unit: int             # the unit's number, -1 outside every unit


def install(monitor: "PerformanceMonitor | None" = None):
    """Make `monitor` (a new one if None) the recorder of every span and
    counter, take its clock pair, and return it."""
    global _installed
    if monitor is None:
        monitor = PerformanceMonitor()
    monitor.clock = (time.perf_counter_ns(), time.time_ns())
    _installed = monitor
    return monitor


def uninstall():
    """Stop recording; returns the monitor that was installed, or None."""
    global _installed
    monitor, _installed = _installed, None
    return monitor


def installed():
    """The installed monitor, or None."""
    return _installed


def span(name: str):
    """A context that records host span `name` in the installed monitor
    (and opens a profiler range of that name while the torch profiler
    runs); a shared null context when neither is on."""
    mon = _installed
    if mon is not None:
        return _Open(mon, name)
    if profiler_on():
        return record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add n to the installed monitor's counter `name`."""
    mon = _installed
    if mon is not None:
        mon.counters[name] += n


def host_read(t: torch.Tensor, site: str):
    """`t.item()`, the Python value of a one-element tensor: a blocking
    device-to-host read, counted in `host_reads` and spanned as
    `host_read.<site>`."""
    mon = _installed
    if mon is None and not profiler_on():
        return t.item()
    if mon is not None:
        mon.counters["host_reads"] += 1
    with span("host_read." + site):
        return t.item()


class _Open:
    """One span while it is open."""

    __slots__ = ("mon", "name", "rec", "rf", "counts0")

    def __init__(self, mon, name):
        self.mon = mon
        self.name = name
        self.rf = None
        self.counts0 = None

    def __enter__(self):
        mon, name = self.mon, self.name
        if profiler_on():
            self.rf = record_function(name)
            self.rf.__enter__()
        if name in UNIT_SPANS:
            if not mon._in_unit:
                mon.unit += 1
                self.counts0 = dict(mon.counters)
            mon._in_unit += 1
        stack = mon._stack
        rec = [name, 0, 0, stack[-1] if stack else -1,
               mon.unit if mon._in_unit else -1]
        stack.append(len(mon._records))
        mon._records.append(rec)
        self.rec = rec
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        mon = self.mon
        mon._stack.pop()
        if self.name in UNIT_SPANS:
            mon._in_unit -= 1
            if self.counts0 is not None:
                c0 = self.counts0
                mon.unit_counts.append({k: v - c0.get(k, 0)
                                        for k, v in mon.counters.items()})
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class PerformanceMonitor:
    """The recorder of the program's host spans and counters (installed with
    `install`), and the reference's named per-frame timers and log
    channels with their JSONL trace output."""

    def __init__(self, trace_path: str | None = None):
        self.trace_path = trace_path
        self._file = open(trace_path, "w") if trace_path else None
        self.timers: dict[str, float] = {}
        self.logs: dict[str, object] = {}
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        for name in REFERENCE_TIMERS:
            self.add_timer(name)
        self.counters: dict[str, int] = defaultdict(int)
        self.unit_counts: list = []     # each unit's growth of the counters
        self.unit = -1
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self._records: list = []
        self._stack: list = []
        self._in_unit = 0

    # -- spans ----------------------------------------------------------------
    def spans(self) -> list:
        """Every span recorded so far, in the order they opened (a parent's
        index is its place in this list); a span still open ends at 0."""
        return [Span(*r) for r in self._records]

    def profiler_ns(self, t_ns: int) -> int:
        """A `perf_counter_ns` time on the profiler's clock (Unix-epoch
        nanoseconds), through the pair taken at `install`."""
        return t_ns - self.clock[0] + self.clock[1]

    def self_ns(self) -> list:
        """Each span's self time: its duration less its children's."""
        own = [r[2] - r[1] for r in self._records]
        for r in self._records:
            if r[3] >= 0:
                own[r[3]] -= r[2] - r[1]
        return own

    def span_table(self, units=None) -> dict:
        """name -> {"spans", "self_ms" (summed), "self_us_per_span",
        "self_ms_per_unit"} over the spans of `units` (a container of unit
        numbers; None: every unit)."""
        own = self.self_ns()
        n_units = len({r[4] for r in self._records if r[4] >= 0
                       and (units is None or r[4] in units)})
        table = {}
        for r, ns in zip(self._records, own):
            if r[4] < 0 or (units is not None and r[4] not in units):
                continue
            row = table.setdefault(r[0], {"spans": 0, "self_ms": 0.0})
            row["spans"] += 1
            row["self_ms"] += ns / 1e6
        for row in table.values():
            row["self_us_per_span"] = 1e3 * row["self_ms"] / row["spans"]
            row["self_ms_per_unit"] = row["self_ms"] / max(n_units, 1)
        return table

    def total_s(self, prefix: str) -> float:
        """Seconds in the spans whose name is `prefix` or starts with
        `prefix.`, each counted once however they nest."""
        def hit(name):
            return name == prefix or name.startswith(prefix + ".")

        total, recs = 0, self._records
        for r in recs:
            if not hit(r[0]):
                continue
            p = r[3]
            while p >= 0 and not hit(recs[p][0]):
                p = recs[p][3]
            if p < 0:
                total += r[2] - r[1]
        return total / 1e9

    # -- per-frame timers and the JSONL trace ---------------------------------
    def add_timer(self, name: str) -> None:
        self.timers.setdefault(name, 0.0)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Span `name` (the installed monitor's, or the profiler's range)
        and this monitor's host wall-clock timer of that name."""
        with span(name):
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


def _add_spans(path: str, mon: PerformanceMonitor, first: int) -> None:
    """Write the monitor's spans from index `first` on into the Chrome
    trace at `path`, as complete ("X") events on a row of their own beside
    the profiler's host threads."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), "program spans"
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": tid}})
    for i, (name, t0, t1, parent, unit) in enumerate(mon._records[first:],
                                                      first):
        if t1 == 0:
            continue
        events.append({"ph": "X", "cat": "program_span", "name": name,
                       "pid": pid, "tid": tid,
                       "ts": (mon.profiler_ns(t0) - base) / 1e3,
                       "dur": (t1 - t0) / 1e3,
                       "args": {"span": i, "parent": parent, "unit": unit}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with `torch.profiler` (host and, where a card is
    present, device activity) and write a Chrome trace to
    `logdir/trace.json`, with the installed monitor's spans of the block
    beside the profiler's events; yields the profiler."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    mon = _installed
    first = len(mon._records) if mon is not None else 0
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if mon is not None:
        _add_spans(path, mon, first)


_DISPATCH_RANGE = "dispatch_counts"


def dispatch_counts(fn) -> tuple[int, int]:
    """(ATen ops, device activities) of one call of `fn` under
    `torch.profiler`: the ATen ops `fn` dispatches itself (those directly
    inside its range, not the ops they call in turn; a port custom op,
    `svo_torch::*`, and a patch function's span, `patch.*`, are looked
    through, and the ATen ops directly inside them count as `fn`'s own)
    and the kernels, copies and sets it puts on the card (the profiler
    ranges' own device spans left out).  The card is synchronised before
    the profile closes, where there is one."""
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
        while p is not None and p.name.startswith(("svo_torch::", "patch.")):
            p = p.cpu_parent
        return p is not None and p.name == _DISPATCH_RANGE

    events = prof.events()
    ranges = {e.name for e in events if e.device_type != DeviceType.CUDA
              and not e.name.startswith("aten::")}
    n_ops = n_dev = 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            n_dev += e.name not in ranges
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
    total_us, n = 0.0, 0
    for evt in prof.key_averages():
        if symbol in evt.key:
            total_us += device_time_us(evt)
            n += evt.count
    return total_us / n / 1e3 if n and total_us > 0 else None
