"""The frame engine: capture → program → sink, latest-frame-wins.

Port of `desktop2stereo_tpu/pipeline/engine.py`: three threads joined by
depth-1 mailboxes, sink-negotiated depth (`wants_depth`), a one-frame
software pipeline (frame N-1 is finished while frame N runs), and delivery of
the final frame before a finite run stops.

The JAX engine's `jax.device_put` and `copy_to_host_async` become, on a CUDA
program: a pinned host staging buffer (a ring of two, each reused only once
its upload has completed) and a `non_blocking` host→device copy; and
device→host copies of the outputs into pinned memory, enqueued right after
the frame is dispatched and waited on through a CUDA event in `_finish`.  A
CPU program takes the frame as is.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.pipeline.metrics import FpsCounter, StageLatency


class Mailbox:
    """Depth-1 latest-wins channel."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._item: Any = None
        self._seq = 0
        self._taken_seq = 0
        self.dropped = 0  # overwrites of a never-consumed item

    def put(self, item: Any) -> None:
        with self._cond:
            if self._item is not None and self._seq > self._taken_seq:
                self.dropped += 1
            self._item = item
            self._seq += 1
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None, last_seq: int = -1) -> Tuple[Any, int]:
        """Blocks until an item newer than `last_seq` arrives (or timeout);
        returns (item, seq), or (None, last_seq) on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._seq <= last_seq or self._item is None:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None, last_seq
                self._cond.wait(remaining)
            self._taken_seq = max(self._taken_seq, self._seq)
            self._cond.notify_all()  # wakes wait_taken
            return self._item, self._seq

    def wait_taken(self, timeout: Optional[float] = None) -> bool:
        """Block until the newest item has been taken (or none was put):
        backpressure for a producer that must not be dropped.  False on
        timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self._taken_seq >= self._seq, timeout)

    @property
    def latest_seq(self) -> int:
        with self._cond:
            return self._seq


@dataclass
class EngineStats:
    fps: float
    fps_1pct_low: float
    frame_ms: float
    latency: dict
    frames: int
    dropped: int
    latency_median: Optional[dict] = None


class _HostStaging:
    """Pinned upload buffers for one CUDA device, a ring of two: a slot is
    rewritten only after the event recorded behind its last upload fired."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._slots: List[Optional[Tuple[torch.Tensor, torch.cuda.Event]]] = [None, None]
        self._next = 0

    def upload(self, frame: np.ndarray) -> torch.Tensor:
        i = self._next
        self._next = 1 - i
        slot = self._slots[i]
        if slot is None or slot[0].shape != frame.shape or slot[0].dtype != torch.uint8:
            slot = (torch.empty(frame.shape, dtype=torch.uint8, pin_memory=True),
                    torch.cuda.Event())
            self._slots[i] = slot
        else:
            slot[1].synchronize()  # its previous upload has left the buffer
        host, event = slot
        host.numpy()[...] = frame
        dev = host.to(self.device, non_blocking=True)
        event.record(torch.cuda.current_stream(self.device))
        return dev


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a device→host copy into fresh pinned memory."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class FrameEngine:
    """source.grab() → program(frame) → sink.push(sbs, depth, stats)."""

    def __init__(self, source, program, sink, target_fps: float = 60.0,
                 shutdown: Optional[threading.Event] = None) -> None:
        self.source = source
        self.program = program
        self.sink = sink
        self.wants_depth = bool(getattr(sink, "wants_depth", True))
        self.target_fps = target_fps
        self.shutdown = shutdown or threading.Event()
        if getattr(program, "device", None) is None:
            raise ValueError(f"FrameEngine needs a program with a `device` (the device its "
                             f"frames are staged on); {type(program).__name__} has none")
        self.device = torch.device(program.device)
        self._staging = _HostStaging(self.device) if self.device.type == "cuda" else None
        self.raw_box = Mailbox()
        self.out_box = Mailbox()
        self.latency = StageLatency()
        self.fps = FpsCounter()
        self.frames = 0
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self.capture_done = threading.Event()
        self._consumed_seq = 0
        self._has_pending = False
        self._sink_seq = 0
        self._sink_busy = False

    # ---- stages ----------------------------------------------------------

    def _capture_loop(self) -> None:
        interval = 1.0 / self.target_fps if self.target_fps > 0 else 0.0
        try:
            while not self.shutdown.is_set():
                t0 = time.perf_counter()
                frame = self.source.grab()
                if frame is None:
                    self.capture_done.set()  # drain what is in flight
                    break
                self.raw_box.put((frame, t0))
                self.latency.record("capture", time.perf_counter() - t0)
                if interval:
                    sleep = interval - (time.perf_counter() - t0)
                    if sleep > 0:
                        time.sleep(sleep)
        except BaseException as e:  # handed to run()/join(), which re-raise it
            self._error = e
            self.shutdown.set()

    def _dispatch(self, frame: np.ndarray):
        """Upload, run, and enqueue the output copies; returns what
        `_finish` waits on."""
        if self._staging is None:
            # a source may hand out a read-only view (the TCP source's frames
            # are its received bytes), which torch.from_numpy does not take
            frame = np.require(frame, requirements="CW")
            sbs, depth = self.program(torch.from_numpy(frame))
            return sbs, depth if self.wants_depth else None, None
        with torch.inference_mode():
            sbs, depth = self.program(self._staging.upload(frame))
            sbs_h = _to_host_async(sbs)
            depth_h = _to_host_async(depth) if self.wants_depth else None
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return sbs_h, depth_h, done

    def _compute_loop(self) -> None:
        seq = -1
        pending = None  # (sbs, depth, event, t0, t_submit)
        try:
            while not self.shutdown.is_set():
                # no frame ready: flush the pending result before blocking,
                # so a paced source's sink gets each frame as soon as it is done
                item, seq = self.raw_box.get(timeout=0.0, last_seq=seq)
                if item is None and pending is not None:
                    self._finish(pending)
                    pending = None
                    self._has_pending = False
                if item is None:
                    item, seq = self.raw_box.get(timeout=0.1, last_seq=seq)
                if item is None:
                    self._consumed_seq = seq
                    continue
                frame, t0 = item
                t1 = time.perf_counter()
                out = self._dispatch(frame)
                if pending is not None:  # finish frame N-1 while N runs
                    self._finish(pending)
                pending = (*out, t0, t1)
                self._has_pending = True
                self._consumed_seq = seq
            if pending is not None:
                self._finish(pending)
                self._has_pending = False
        except BaseException as e:  # handed to run()/join(), which re-raise it
            self._error = e
            self.shutdown.set()

    def _finish(self, pending) -> None:
        sbs, depth, done, t0, t1 = pending
        if done is not None:
            done.synchronize()
        sbs_np = sbs.numpy()
        depth_np = depth.numpy() if depth is not None else None
        self.latency.record("depth+compose", time.perf_counter() - t1)
        self.out_box.put((sbs_np, depth_np, t0))
        self.frames += 1
        self.fps.tick()

    def _sink_loop(self) -> None:
        seq = -1
        try:
            while not self.shutdown.is_set():
                item, seq = self.out_box.get(timeout=0.1, last_seq=seq)
                if item is None:
                    continue
                sbs_np, depth, t0 = item
                t1 = time.perf_counter()
                self._sink_busy = True
                try:
                    self.sink.push(sbs_np, depth, self.stats())
                finally:
                    self._sink_busy = False
                    self._sink_seq = seq
                self.latency.record("sink", time.perf_counter() - t1)
        except BaseException as e:  # handed to run()/join(), which re-raise it
            self._error = e
            self.shutdown.set()

    # ---- lifecycle ---------------------------------------------------------

    @property
    def dropped(self) -> int:
        return self.raw_box.dropped + self.out_box.dropped

    def preload(self, frame, t0: Optional[float] = None) -> None:
        """Enqueue a frame captured before start() (the CLI's shape probe),
        so it is processed as frame 0, through the same staging as every
        other frame, rather than lost."""
        self.raw_box.put((frame, t0 if t0 is not None else time.perf_counter()))

    def start(self) -> None:
        for name, fn in (("capture", self._capture_loop),
                         ("compute", self._compute_loop),
                         ("sink", self._sink_loop)):
            t = threading.Thread(target=fn, name=f"d2s-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(remaining)
        if self._error is not None:
            raise self._error

    def drained(self) -> bool:
        """Source exhausted, every captured frame consumed, and the sink done
        with the newest composed frame."""
        return (self.capture_done.is_set()
                and not self._has_pending
                and self._consumed_seq >= self.raw_box.latest_seq
                and self._sink_seq >= self.out_box.latest_seq
                and not self._sink_busy)

    def _wait_sink_drain(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        while (not self.shutdown.is_set() and time.monotonic() < deadline
               and (self._sink_busy or self._sink_seq < self.out_box.latest_seq)):
            time.sleep(0.01)

    def run(self, duration: Optional[float] = None,
            max_frames: Optional[int] = None) -> EngineStats:
        """Blocking: start, wait until drained (or duration / max_frames), stop."""
        self.start()
        t_end = None if duration is None else time.monotonic() + duration
        while not self.shutdown.is_set():
            if t_end is not None and time.monotonic() >= t_end:
                break
            if max_frames is not None and self.frames >= max_frames:
                break
            if self.drained():
                break
            time.sleep(0.01)
        self._wait_sink_drain()
        self.stop()
        return self.stats_final()

    def stop(self) -> None:
        self.shutdown.set()
        self.join(timeout=5.0)

    def stats(self) -> Dict[str, Any]:
        s: Dict[str, Any] = self.fps.stats()
        s["latency"] = self.latency.snapshot()
        s["frames"] = self.frames
        s["dropped"] = self.dropped
        return s

    def stats_final(self) -> EngineStats:
        s = self.fps.stats()
        return EngineStats(fps=s["fps"], fps_1pct_low=s["fps_1pct_low"],
                           frame_ms=s["frame_ms"], latency=self.latency.snapshot(),
                           frames=self.frames, dropped=self.dropped,
                           latency_median=self.latency.medians())
