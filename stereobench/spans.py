"""The program's own spans and the trace's runtime calls, for the metrics
that read them.

The program keeps its spans in memory (`desktop2stereo_tpu_torch/pipeline/
profiling.py`): each engine a span log, its newest ones listed by
`recent_engine_logs()`, and set-up spans in `PROCESS_LOG`.  A span has a
name, a start and an end on `time.perf_counter_ns()` (the harness's clock),
and the ids of the frames it belongs to.  While a profiler runs, the log
stamps one `d2s.clock` range, so that a span lies on the trace's timeline
at `host_ns / 1e3 + offset`.  A program without them (an older one) gives
None throughout, and the metrics that read them are left out.

A frame's parts: `d2s.grab` (capture; its start is the frame's `t0`), the
`taken` mark (the compute thread takes it from the capture mailbox),
`d2s.dispatch` (staging, the program call, the copies back, the event),
`d2s.finish` (the wait and the put into the output mailbox) and `d2s.sink`
(the push; the harness stamps the delivery inside it).  The trace's
`cuda_runtime` and `cuda_driver` events are the host's runtime calls, each
with its duration and the correlation id of the device work it started.
"""

from __future__ import annotations

import bisect
import re
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from stereobench.trace import DEVICE_CATS

PARTS = ("d2s.grab", "taken", "d2s.dispatch", "d2s.finish", "d2s.sink")
STAGES = ("d2s.preprocess", "d2s.model", "d2s.tail", "d2s.post", "d2s.stereo")
CLOCK = "d2s.clock"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# a kernel launch: the runtime's and the driver's entries, and a graph's
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchCooperativeKernel|cuLaunchKernel|"
                    r"cuLaunchCooperativeKernel|cudaGraphLaunch|cuGraphLaunch)")
# runtime calls that hold the host until the device or the allocator is done
BLOCKING = re.compile(r"^(cuda(Device|Stream|Event)Synchronize|cu(Ctx|Stream|Event)Synchronize|"
                      r"cudaMemcpy(2D|3D)?|cudaMalloc(Host)?|cudaHostAlloc|cudaFree(Host)?|"
                      r"cuMem(Alloc|Free|AllocHost|HostAlloc|FreeHost)(_v2)?)$")

Span = Tuple[str, int, int, tuple]  # (name, start ns, end ns, frame ids)


def _profiling():
    try:
        from desktop2stereo_tpu_torch.pipeline import profiling
    except ImportError:
        return None
    return profiling


def _plain(spans) -> Optional[List[Span]]:
    try:
        return [(s.name, int(s.start), int(s.end), tuple(s.frames)) for s in spans]
    except (AttributeError, TypeError):
        return None


def engine_spans() -> Optional[Tuple[List[Span], List[int]]]:
    """(the newest engine's spans, its clock stamps in ns), or None."""
    logs = getattr(_profiling(), "recent_engine_logs", None)
    if logs is None or not logs():
        return None
    log = logs()[-1]
    spans = _plain(log.spans())
    clocks = _plain(getattr(log, "clocks", ()))
    if spans is None or clocks is None:
        return None
    return spans, [c[1] for c in clocks]


def setup_seconds(name: str) -> Optional[float]:
    """Seconds of the process's set-up spans named `name`, or None."""
    log = getattr(_profiling(), "PROCESS_LOG", None)
    spans = None if log is None else _plain(log.spans())
    if not spans:
        return None
    xs = [(b - a) / 1e9 for n, a, b, _ in spans if n == name]
    return sum(xs) if xs else None


# ---- frames on the host clock ------------------------------------------------

def frame_parts(spans: Sequence[Span]) -> Dict[tuple, Dict[str, Span]]:
    """{frame id: {part: its first span}} for the frames that have all five."""
    by: Dict[tuple, Dict[str, Span]] = {}
    for s in spans:
        if s[0] in PARTS:
            for f in s[3]:
                by.setdefault(f, {}).setdefault(s[0], s)
    return {f: parts for f, parts in by.items() if len(parts) == len(PARTS)}


def window_frames(run, spans: Sequence[Span]) -> List[Dict[str, Span]]:
    """The parts of the frames delivered (the start of `d2s.sink`) in the
    window before the profiler started."""
    w0 = run.window[0]
    w1 = run.profiled_from if run.profiled_from is not None else run.window[1]
    return [p for p in frame_parts(spans).values() if w0 <= p["d2s.sink"][1] / 1e9 < w1]


def median_ms(run, gap) -> Optional[float]:
    """The median over the window's frames of `gap(parts)` (ns), in ms."""
    got = engine_spans()
    if got is None:
        return None
    xs = [gap(p) for p in window_frames(run, got[0])]
    return statistics.median(xs) / 1e6 if xs else None


# ---- the trace -------------------------------------------------------------------

def clock_offset_us(events: Sequence[dict], clocks: Sequence[int]) -> Optional[float]:
    """The trace's newest `d2s.clock` range's `ts` less the log's newest
    clock stamp, µs; None where either has none."""
    ts = [float(e["ts"]) for e in events
          if e.get("cat") == "user_annotation" and e.get("name") == CLOCK]
    if not ts or not clocks:
        return None
    return max(ts) - clocks[-1] / 1e3


def _compute_tid(events: Sequence[dict]):
    """The thread of the program's stage ranges (the engine's compute
    thread), or None."""
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == "d2s.model":
            return e.get("tid")
    return None


def runtime_calls(events: Sequence[dict]) -> List[dict]:
    """The runtime and driver calls of the compute thread, by start; every
    thread's where none carries that thread's id."""
    calls = [e for e in events if e.get("cat") in RUNTIME_CATS and "dur" in e]
    tid = _compute_tid(events)
    mine = [e for e in calls if e.get("tid") == tid]
    return sorted(mine or calls, key=lambda e: float(e["ts"]))


def in_stages(slice_, pattern) -> Optional[Tuple[List[dict], int]]:
    """(the compute thread's runtime calls matching `pattern` that start
    inside the program's stage ranges in the slice, the slice's steps: its
    `d2s.model` ranges); None where the slice holds no step."""
    stages = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in slice_.events
                    if e.get("cat") == "user_annotation" and e.get("name") in STAGES
                    and slice_.start <= float(e["ts"]) < slice_.end)
    steps = len(slice_.ranges("d2s.model", gpu=False))
    if not steps:
        return None
    starts = [a for a, _ in stages]
    out = []
    for e in runtime_calls(slice_.events):
        t = float(e["ts"])
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < stages[i][1] and pattern.match(str(e.get("name", ""))):
            out.append(e)
    return out, steps


def device_end_us(a: float, b: float, calls: Sequence[dict], starts: Sequence[float],
                  ends: Dict[int, float]) -> Optional[float]:
    """The end (trace µs) of the device work that the runtime calls made in
    [a, b) started; `calls` by start (`starts`), `ends` the device end of
    each correlation id."""
    lo, hi = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
    got = [ends[c] for c in (calls[i].get("args", {}).get("correlation") for i in range(lo, hi))
           if c in ends]
    return max(got) if got else None


def device_ends(events: Sequence[dict]) -> Dict[int, float]:
    """{correlation id: the end (µs) of the device work it started}."""
    ends: Dict[int, float] = {}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and "dur" in e and c is not None:
            ends[c] = max(ends.get(c, float("-inf")), float(e["ts"]) + float(e["dur"]))
    return ends
