"""Reduction of a profiled stretch (`torch.profiler`, host and device) to
what the per-layer readers take.  It reads the profiler's raw records
(`Event`), not the function-event tree torch builds from them, which
costs a minute for a stretch of a few frames.

  device activities   every kernel, copy and set on the card, the
                      profiler ranges' own device spans left out
  busy                the union of the activities' intervals over the
                      stretch's wall time (overlapping copies and kernels
                      count once)
  per unit            the activities that start inside a unit's
                      `svo_bench.frame` / `svo_bench.step` range: each unit
                      ends with its poses on the host, so its device work
                      ends inside it
  per range           the device work launched inside a host range (the
                      runtime call with the activity's correlation id lies
                      inside it), in the order the ranges open: `local_ba`,
                      and each `svo_bench.<kind>` range around a patch
                      function
  idle gaps           the gaps between busy intervals, named by the
                      innermost host range open where each begins
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple


class Event(NamedTuple):
    name: str
    start: float          # microseconds
    end: float
    device: bool          # on the card
    corr: int             # correlation id: a launch and its activity share it
    annotation: bool      # a profiler range (record_function)


# the program's own ranges (`core/pipeline.py`, `utils/profiling.py`), for
# a profiler that does not mark its ranges as annotations
RANGES = {"pyramid_creation", "sparse_img_align", "reproject",
          "pose_optimizer", "point_optimizer", "depth_filter", "keyframe",
          "local_ba", "tot_time", "fused_track_dispatch"}


def from_profiler(prof) -> list:
    """The raw records of a stopped `torch.profiler.profile`."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append(Event(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                         e.device_type() == DeviceType.CUDA,
                         e.correlation_id(), bool(e.is_user_annotation())))
    return out


def union_seconds(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of [start, end] intervals (microseconds) clipped
    to [lo, hi], in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def idle_gaps(intervals: list, lo: float, hi: float) -> list:
    """The gaps (start, end) in microseconds between the busy intervals
    inside [lo, hi]."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def reduce_events(events: list, unit_range: str) -> dict:
    """The stretch's numbers from its records; `unit_range` names the
    harness's range around each unit."""
    host = [e for e in events if not e.device]
    annotations = {e.name for e in host if e.annotation or e.name in RANGES
                   or e.name.startswith("svo_bench.")}
    dev = [e for e in events if e.device and e.name not in annotations]
    iv = [(e.start, e.end) for e in dev]
    units = sorted((e.start, e.end) for e in host if e.name == unit_range)
    out = {"units": [], "ranges": defaultdict(list)}
    if not units:
        return out
    lo, hi = units[0][0], units[-1][1]
    starts = sorted(s for s, _ in iv)
    for s, e in units:
        n = bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
        out["units"].append({"activities": n, "wall_s": (e - s) / 1e6})
    out["window_s"] = (hi - lo) / 1e6
    out["busy_s"] = union_seconds(iv, lo, hi)

    launch = {e.corr: e.start for e in host
              if e.name.startswith("cu") and e.corr}
    linked = sorted((launch[e.corr], e.end - e.start) for e in dev
                    if e.corr in launch)
    out["linked_share"] = len(linked) / len(dev) if dev else 0.0
    at = [t for t, _ in linked]
    cum = [0.0]
    for _, d in linked:
        cum.append(cum[-1] + d)
    for e in sorted(host, key=lambda x: x.start):
        if e.name == "local_ba" or e.name.startswith("svo_bench."):
            i = bisect.bisect_left(at, e.start)
            j = bisect.bisect_right(at, e.end)
            out["ranges"][e.name].append((j - i, cum[j] - cum[i]))

    by_name = defaultdict(float)
    for e in dev:
        if lo <= e.start <= hi:
            by_name[e.name] += (e.end - e.start) / 1e6
    out["device_ops"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # what the host was doing through each idle gap: the innermost
    # annotation open where the gap begins (ranges on one thread nest)
    spans = sorted(((e.start, e.end, e.name) for e in host
                    if e.name in annotations and e.name != unit_range),
                   key=lambda x: (x[0], -x[1]))
    named, open_, i = defaultdict(float), [], 0
    for g0, g1 in idle_gaps(iv, lo, hi):
        while i < len(spans) and spans[i][0] <= g0:
            while open_ and open_[-1][1] < spans[i][0]:
                open_.pop()
            open_.append(spans[i])
            i += 1
        while open_ and open_[-1][1] < g0:
            open_.pop()
        named[open_[-1][2] if open_ else "host"] += (g1 - g0) / 1e6
    out["idle_gaps"] = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return out
