"""Tracing and profiling hooks: torch.profiler and NVTX.

Port of `desktop2stereo_tpu/pipeline/profiling.py`.  The JAX module starts
the process-wide JAX/XLA profiler; here `torch.profiler` takes its place,
with CPU and CUDA activity, writing a Chrome trace (chrome://tracing,
Perfetto) into the trace directory, and `annotate` marks a region both as
a profiler range (`record_function`) and as an NVTX range (for Nsight
Systems).  The per-stage wall clock lives in `pipeline/metrics.py`;
`StageTimer` adds the range around it.

torch.profiler records the CPU ranges of the thread that starts it (the
CUDA activity of the whole process comes through CUPTI either way), so a
trace is started and stopped on the thread that runs the frames: the
engines' compute thread runs a `TraceRequest` that the CLI's
`--profile-dir` hands it, and `start_trace` / `stop_trace` work on the
calling thread.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional

import torch

_local = threading.local()  # the calling thread's running trace: (profiler, dir)


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the profiler's timeline and, with a card, an NVTX
    range; usable around host-side stage code."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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


class StageTimer:
    """Profiler-annotated per-stage wall timing (the reference's
    thread_latencies dict, main.py:70-77).

    The EMA and history live in one place, `metrics.StageLatency`; this
    wrapper adds the `d2s.<stage>` range, and records the sample even when
    the block raises, so a failing stage still shows its cost."""

    def __init__(self, alpha: float = 0.9):
        from desktop2stereo_tpu_torch.pipeline.metrics import StageLatency

        self.alpha = alpha
        self._lat = StageLatency()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(f"d2s.{name}"):
                yield
        finally:
            self._lat.record(name, time.perf_counter() - t0, ema_alpha=self.alpha)

    @property
    def latency(self) -> dict:
        return self._lat.snapshot()

    def snapshot(self) -> dict:
        return self._lat.snapshot()
