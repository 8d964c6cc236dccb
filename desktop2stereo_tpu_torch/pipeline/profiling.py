"""Tracing: the span log, profiler and NVTX ranges, and traces of a thread.

Port of `desktop2stereo_tpu/pipeline/profiling.py`.  The JAX module starts
the process-wide JAX/XLA profiler; here `torch.profiler` takes its place,
with CPU and CUDA activity, writing a Chrome trace (chrome://tracing,
Perfetto) into the trace directory.

`annotate(name)` is the one way to open a range.  It marks the region as an
NVTX range (for Nsight Systems); as a profiler range (`record_function`)
while a profiler records the calling thread; and as a span in the span log
bound to the calling thread (`bind`), where there is one.  A `SpanLog`
keeps spans in memory, in a bounded ring: each with its name, start and end
on `time.perf_counter_ns()`, its thread, the frames it belongs to
(`(feed, capture sequence number)` each, shared by every span of a frame)
and its parent span.  The engines own one each (`engine.spans`); set-up
spans (`d2s.setup.*`) go into the process-wide `PROCESS_LOG`, since no
engine exists when they run.

One clock with the device trace: while a profiler records a thread, the
thread's second top-level span (a frame boundary; the first one's ranges
carry the profiler's set-up on that thread) opens one `d2s.clock` range,
and the log stamps that range's start itself (`SpanLog.clocks`).  A span is then placed
on the trace's timeline by `trace_us = host_ns / 1e3 + offset`, where
`offset` is the trace's `ts` of that range less its stamp (`clock_offset_us`),
with no fit.

torch.profiler records the CPU ranges of the thread that starts it (the
CUDA activity of the whole process comes through CUPTI either way), so a
trace is started and stopped on the thread that runs the frames: the
engines' compute thread runs a `TraceRequest` that the CLI's
`--profile-dir` hands it, and `start_trace` / `stop_trace` work on the
calling thread.  `ModuleRanges` adds a range around each of a model's child
modules while, and only while, a profiler records the thread that runs it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import torch

CLOCK = "d2s.clock"
FrameId = Tuple[int, int]  # (feed, capture sequence number)

_local = threading.local()  # the calling thread's running trace and bound span log


def recording() -> bool:
    """Whether a torch profiler records the calling thread's ranges."""
    return torch._C._autograd._profiler_enabled()


# A profiler range (a `user_annotation`, as `torch.profiler.record_function`
# opens) through the bindings under it: a few µs less on the host, and its
# stamps lie within a few µs of the spans' own
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit


@functools.cache
def _nvtx() -> bool:
    return torch.cuda.is_available()


class Span:
    """One timed region: `start` and `end` in `time.perf_counter_ns()`,
    `frames` the ids of the frames it belongs to, `parent` the id of the
    span open around it on its thread (0: none)."""

    __slots__ = ("id", "name", "start", "end", "thread", "frames", "parent")

    def __init__(self, id: int, name: str, start: int, end: int, thread: int,
                 frames: Tuple[FrameId, ...], parent: int) -> None:
        self.id, self.name, self.start, self.end = id, name, start, end
        self.thread, self.frames, self.parent = thread, frames, parent

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "start_ns": self.start, "end_ns": self.end,
                "thread": self.thread, "frames": [list(f) for f in self.frames],
                "parent": self.parent}


class SpanLog:
    """Spans in memory, the newest `capacity` closed ones (`spans()`), and
    the `d2s.clock` stamps (`clocks`).  Any thread may open spans; each
    thread's open spans nest."""

    def __init__(self, capacity: int = 1 << 15) -> None:
        self._ring: Deque[Span] = deque(maxlen=capacity)
        self.clocks: Deque[Span] = deque(maxlen=16)
        self._ids = itertools.count(1)
        # per thread: .stack, its open spans; .traced, the top-level spans
        # opened under the running profiler, up to the clock's (2)
        self._threads = threading.local()

    def _thread(self):
        t = self._threads
        if not hasattr(t, "stack"):
            t.stack, t.traced, t.ident = [], 0, threading.get_ident()
        return t

    def begin(self, name: str, frames: Optional[Tuple[FrameId, ...]] = None,
              traced: bool = False) -> Span:
        """Open a span on the calling thread; `frames` None: its parent's.
        `traced`: a profiler records this thread, so the thread's second
        top-level span under it also opens the `d2s.clock` range."""
        t = self._thread()
        parent = t.stack[-1] if t.stack else None
        if frames is None:
            frames = parent.frames if parent is not None else ()
        if parent is None:
            if not traced:
                t.traced = 0
            elif t.traced < 2:
                t.traced += 1
                if t.traced == 2:
                    stamp = time.perf_counter_ns()
                    _range_exit(_range_enter(CLOCK))
                    self.clocks.append(Span(next(self._ids), CLOCK, stamp, stamp, t.ident,
                                            frames, 0))
        span = Span(next(self._ids), name, time.perf_counter_ns(), 0, t.ident, frames,
                    parent.id if parent is not None else 0)
        t.stack.append(span)
        return span

    def end(self, span: Span) -> Span:
        span.end = time.perf_counter_ns()
        stack = self._thread().stack
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            stack.remove(span)
        self._ring.append(span)
        return span

    def mark(self, name: str, frames: Tuple[FrameId, ...]) -> Span:
        """A zero-length span at this instant."""
        now = time.perf_counter_ns()
        t = self._thread()
        span = Span(next(self._ids), name, now, now, t.ident, frames,
                    t.stack[-1].id if t.stack else 0)
        self._ring.append(span)
        return span

    def spans(self) -> List[Span]:
        return list(self._ring)

    def as_dict(self, offset_us: Optional[float] = None) -> dict:
        spans = self.spans()
        return {"clock_offset_us": offset_us, "clocks": [c.as_dict() for c in self.clocks],
                "spans": [s.as_dict() for s in spans], "frames": frame_split(spans)}


PROCESS_LOG = SpanLog(capacity=1024)  # set-up spans, made before any engine
_ENGINE_LOGS: Deque[SpanLog] = deque(maxlen=4)


def engine_log() -> SpanLog:
    """A new engine's span log, also kept among the process's newest four
    (`recent_engine_logs`), where a reader that sees no engine finds it."""
    log = SpanLog()
    _ENGINE_LOGS.append(log)
    return log


def recent_engine_logs() -> List[SpanLog]:
    """The span logs of the newest engines made in this process, newest last."""
    return list(_ENGINE_LOGS)


def bind(log: Optional[SpanLog]) -> None:
    """Make `log` the calling thread's span log (None: no log)."""
    _local.log = log


class annotate:
    """`with annotate(name) as span:` a named region: an NVTX range with a
    card, a profiler range while a profiler records this thread, and a span
    in `log` (default: the span log bound to this thread; `span` is None
    where there is none).  `frames`: the frames the span belongs to, else
    its parent span's.  The span's start is stamped just before the profiler
    range opens and its end just after it closes, next to the profiler's own
    stamps (a range's opening may take tens of µs after its stamp)."""

    __slots__ = ("name", "frames", "log", "span", "_rf", "_nvtx")

    def __init__(self, name: str, frames: Optional[Tuple[FrameId, ...]] = None,
                 log: Optional[SpanLog] = None) -> None:
        self.name, self.frames = name, frames
        self.log = log if log is not None else getattr(_local, "log", None)

    def __enter__(self) -> Optional[Span]:
        traced = recording()
        self.span = None if self.log is None else self.log.begin(self.name, self.frames, traced)
        self._rf = None
        if traced:
            if self.span is not None:
                self.span.start = time.perf_counter_ns()  # next to the range's own stamp
            self._rf = _range_enter(self.name)
        self._nvtx = _nvtx()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self.span

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._rf is not None:
            _range_exit(self._rf)
        if self.span is not None:
            self.log.end(self.span)
        return False


class ModuleRanges:
    """A `d2s.model/<path>` range around each call of each child module of
    `model` (a ModuleList's or ModuleDict's items, one level down), through
    forward hooks that exist only while a profiler records the thread that
    runs the model: `with ranges:` around the model's call adds the hooks
    at the first call under a profiler and removes them at the first call
    after it, and closes any range an exception left open."""

    def __init__(self, model: torch.nn.Module) -> None:
        self.model = model
        self._handles: list = []
        self._open: List[annotate] = []

    def targets(self) -> Iterator[Tuple[str, torch.nn.Module]]:
        for name, child in self.model.named_children():
            if isinstance(child, (torch.nn.ModuleList, torch.nn.ModuleDict)):
                for sub, item in child.named_children():
                    yield f"{name}.{sub}", item
            else:
                yield name, child

    @property
    def hooked(self) -> bool:
        return bool(self._handles)

    def __enter__(self) -> "ModuleRanges":
        if recording() != self.hooked:
            if self._handles:
                for h in self._handles:
                    h.remove()
                self._handles = []
            else:
                for path, module in self.targets():
                    self._handles += [module.register_forward_pre_hook(self._opener(path)),
                                      module.register_forward_hook(self._close)]
        return self

    def __exit__(self, *exc) -> bool:
        while self._open:
            self._open.pop().__exit__(None, None, None)
        return False

    def _opener(self, path: str):
        name = f"d2s.model/{path}"

        def hook(module, args):
            rng = annotate(name)
            rng.__enter__()
            self._open.append(rng)
        return hook

    def _close(self, module, args, out) -> None:
        if self._open:
            self._open.pop().__exit__(None, None, None)


# ---- the per-frame split and the exporter ------------------------------------

def frame_split(spans: List[Span]) -> List[dict]:
    """Each delivered frame's latency in parts, ms, from its spans: `queue`
    (capture to the compute thread's `taken`), `dispatch` (`taken` to the
    end of `d2s.dispatch`), `held` (to the start of `d2s.finish`),
    `deliver` (to the start of `d2s.sink`); they add up to `latency`, from
    the start of `d2s.grab` to the start of `d2s.sink`."""
    first: Dict[FrameId, Dict[str, Span]] = {}
    for s in spans:
        if s.name in ("d2s.grab", "taken", "d2s.dispatch", "d2s.finish", "d2s.sink"):
            for f in s.frames:
                first.setdefault(f, {}).setdefault(s.name, s)
    out = []
    for f, by in sorted(first.items()):
        if len(by) < 5:
            continue
        t0, taken = by["d2s.grab"].start, by["taken"].start
        dispatched, finish = by["d2s.dispatch"].end, by["d2s.finish"].start
        sink = by["d2s.sink"].start
        out.append({"frame": list(f), "t0_ns": t0,
                    "queue_ms": (taken - t0) / 1e6, "dispatch_ms": (dispatched - taken) / 1e6,
                    "held_ms": (finish - dispatched) / 1e6, "deliver_ms": (sink - finish) / 1e6,
                    "latency_ms": (sink - t0) / 1e6})
    return out


def clock_offset_us(log: SpanLog, events: List[dict]) -> Optional[float]:
    """The trace's `ts` (µs) of its newest `d2s.clock` range less the log's
    newest clock stamp (µs); None where either has none."""
    ts = [float(e["ts"]) for e in events
          if e.get("name") == CLOCK and e.get("cat") == "user_annotation"]
    if not ts or not log.clocks:
        return None
    return max(ts) - log.clocks[-1].start / 1e3


def export_spans(log: SpanLog, trace_path: str) -> str:
    """Write `log` as JSON beside the Chrome trace at `trace_path`, with the
    clock offset that places its spans on the trace; → the file's path."""
    with open(trace_path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    path = os.path.splitext(trace_path)[0] + ".spans.json"
    with open(path, "w") as f:
        json.dump(log.as_dict(clock_offset_us(log, events)), f)
    return path


# ---- traces ---------------------------------------------------------------------

def start_trace(log_dir: Optional[str] = None) -> str:
    """Begin a torch.profiler trace on this thread (CPU and, with a card,
    CUDA activity) into `log_dir` (default $D2S_TRACE_DIR, else logs/trace);
    returns the directory."""
    from torch.profiler import ProfilerActivity, profile

    if getattr(_local, "trace", None) is not None:
        raise RuntimeError("a trace is already running on this thread")
    log_dir = log_dir or os.environ.get("D2S_TRACE_DIR", "logs/trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _local.trace = (prof, log_dir)
    return log_dir


def stop_trace() -> str:
    """End this thread's trace and write it; returns the Chrome trace's path."""
    trace = getattr(_local, "trace", None)
    if trace is None:
        raise RuntimeError("no trace is running on this thread")
    _local.trace = None
    prof, log_dir = trace
    prof.stop()
    path = os.path.join(log_dir, f"d2s_trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}"
                                 f"_{threading.get_ident()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    d = start_trace(log_dir)
    try:
        yield d
    finally:
        stop_trace()


class TraceRequest:
    """A trace that a worker thread runs on itself, from `begin()` (its
    first act) to `end()` (its last, or the first `poll()` after `finish`
    was asked for); `finish(timeout)` may run on any thread and waits for
    the file.  `path` is the Chrome trace once written.

    Made on the main thread, it starts and stops an empty profile there
    first: the profiler's first start sets up CUPTI, which takes seconds on
    a CUDA host, and a worker thread's trace would lose them from its run
    (the profiler's client, registered on the main thread, initialises only
    there)."""

    def __init__(self, log_dir: Optional[str] = None) -> None:
        self.log_dir = log_dir
        self.path: Optional[str] = None
        self._running = False
        self._stop = threading.Event()
        self._done = threading.Event()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            pass

    def begin(self) -> None:
        start_trace(self.log_dir)
        self._running = True

    def poll(self) -> None:
        if self._running and self._stop.is_set():
            self.end()

    def end(self) -> None:
        if self._running:
            self._running = False
            try:
                self.path = stop_trace()
            finally:
                self._done.set()

    def finish(self, timeout: Optional[float] = None) -> Optional[str]:
        """Ask the worker to stop the trace, wait for the file (at most
        `timeout` s); its path, or None if none was written in time."""
        self._stop.set()
        self._done.wait(timeout)
        return self.path
