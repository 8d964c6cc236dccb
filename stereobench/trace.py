"""Reading the profiler's trace of a slice of the window.

The traced run starts `torch.profiler` (CPU and CUDA activity) on the
engine's compute thread for a short slice at the end of the window and
exports a Chrome trace.  Its CPU side holds the program's `d2s.*` ranges
and the harness's `bench.*` ranges; its device side the kernels, copies and
fills, and, for each CPU range, a `gpu_user_annotation` range spanning the
device work launched inside it.

The slice read runs from the start of the `warm`-th traced step's
`bench.dispatch` range (CUPTI loses the records of the first launches
after a start) to the start of the last traced step's, so it holds whole
steps.  Busy time is the union of the device's activity intervals inside
the slice, as `chip_smoke.py`'s `summarize_trace` reckons it.
"""

from __future__ import annotations

import bisect
import json
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from stereobench.record import RANGE_DISPATCH

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_RANGE = "engine loop, outside any range"


def busy_intervals(events: Sequence[dict], a: float, b: float) -> List[Tuple[float, float]]:
    """The union of the device activity intervals clipped to [a, b), merged
    and in order (µs)."""
    spans = sorted((max(float(e["ts"]), a), min(float(e["ts"]) + float(e["dur"]), b))
                   for e in events if e.get("cat") in DEVICE_CATS and "dur" in e)
    merged: List[List[float]] = []
    for s, t in spans:
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


class TraceSlice:
    """The steady slice of one traced window.  `step_times` are the host
    clock (`time.perf_counter`) starts of the program calls made while the
    profiler ran, in order, so that trace time maps to the host clock."""

    def __init__(self, events: Sequence[dict], step_times: Sequence[float], warm: int = 2):
        self.events = events
        dispatch = sorted(float(e["ts"]) for e in events
                          if e.get("cat") == "user_annotation" and e.get("name") == RANGE_DISPATCH)
        if len(dispatch) < warm + 2:
            raise ValueError(f"the trace holds {len(dispatch)} program calls; the slice needs "
                             f"at least {warm + 2}")
        self.start, self.end = dispatch[warm], dispatch[-1]
        self.steps = len(dispatch) - 1 - warm
        n = min(len(dispatch), len(step_times))
        self.offset_s = statistics.median(
            d / 1e6 - t for d, t in zip(dispatch[-n:], list(step_times)[-n:]))
        # the device work overlapping the slice (its steps' work runs behind
        # their dispatch, so some of it began before the slice)
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
                       and float(e["ts"]) < self.end
                       and float(e["ts"]) + float(e["dur"]) > self.start]
        self.busy = busy_intervals(self.device, self.start, self.end)

    # ---- time ---------------------------------------------------------------

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) / 1e6

    def host_bounds(self) -> Tuple[float, float]:
        """The slice on the host clock."""
        return self.start / 1e6 - self.offset_s, self.end / 1e6 - self.offset_s

    # ---- ranges and kernels ---------------------------------------------------

    def ranges(self, name: str, gpu: bool = True) -> List[Tuple[float, float]]:
        """The slice's ranges of one name, device side (`gpu`) or host side."""
        cat = "gpu_user_annotation" if gpu else "user_annotation"
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.events
                      if e.get("cat") == cat and e.get("name") == name
                      and self.start <= float(e["ts"]) < self.end)

    def kernels_in(self, ranges: Sequence[Tuple[float, float]], pattern=None) -> List[dict]:
        """Kernels that start inside one of `ranges`, those whose name
        matches `pattern` (a compiled regex) where one is given."""
        starts = [a for a, _ in ranges]
        out = []
        for e in self.device:
            if e["cat"] != "kernel" or (pattern is not None and not pattern.search(e["name"])):
                continue
            t = float(e["ts"])
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ranges[i][1]:
                out.append(e)
        return out

    def device_ms_per_range(self, names: Sequence[str]) -> Optional[float]:
        """Device ms of the kernels inside the ranges of `names`, over the
        number of ranges of the first name (one a step); None where the
        slice holds none."""
        first = self.ranges(names[0])
        if not first:
            return None
        total = 0.0
        for name in names:
            total += sum(float(e["dur"]) for e in self.kernels_in(self.ranges(name)))
        return total / 1e3 / len(first)

    # ---- breakdown -------------------------------------------------------------

    def top_ops(self, k: int = 10) -> List[List]:
        """The device operations that took the most time in the slice, s."""
        by_name: Dict[str, float] = {}
        for e in self.device:
            name = (e["name"] if e["cat"] == "kernel" else f"{e['cat']}: {e['name']}")[:160]
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            by_name[name] = by_name.get(name, 0.0) + (min(b, self.end) - max(a, self.start)) / 1e6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle time in the slice, s, by the innermost host range
        open where each gap begins (the program's `d2s.*` and the harness's
        `bench.*` ranges)."""
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                      for e in self.events if e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith(("d2s.", "bench.")))
        starts = [r[0] for r in host]
        reach, m = [], float("-inf")  # reach[i]: the latest end among ranges 0..i
        for r in host:
            m = max(m, r[1])
            reach.append(m)
        gaps, at = [], self.start
        for s, t in self.busy + [(self.end, self.end)]:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        by_label: Dict[str, float] = {}
        for a, b in gaps:
            # ranges of one thread nest or are disjoint: the innermost one
            # open at `a` is the latest-starting one that has not ended
            label = NO_RANGE
            for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
                if reach[i] <= a:
                    break
                if host[i][1] > a:
                    label = host[i][2]
                    break
            by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:k]]


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
