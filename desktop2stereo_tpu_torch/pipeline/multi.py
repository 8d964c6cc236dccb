"""Multi-stream serving: N capture feeds through one frame program.

Port of `desktop2stereo_tpu/pipeline/multi.py`.  One card serves several
concurrent feeds (dual-display capture, several remote clients) through the
same program with per-stream carried state: `MultiStreamEngine`
round-robins the streams through a `ProgramCache` (its `stream` key), and
`BatchedStreamEngine` stacks the newest frame of every stream into one
batch a launch for a `BatchedProgramCache`.

The semantics are the JAX engine's, per stream: latest-frame-wins with a
depth-1 mailbox each (a slow stream drops its own frames and never stalls
the others), one compute thread with a one-frame software pipeline per
stream, an exhausted stream's pending result flushed at once, a bounded
drain on exit, sink-negotiated depth (`wants_depth`), and an error in any
thread stops the engine and is re-raised by `run()`.

The transfers are `FrameEngine`'s (`pipeline/engine.py`) on a CUDA
program: each stream uploads through its own pinned staging ring (streams
may differ in shape when not batched); the batched engine copies each
stream's newest frame straight into its row of one pinned [S, H, W, C]
slot and uploads the slot once; each launch's outputs come back in one
device→host copy into pinned memory (the [S, ...] batch sliced per stream
on the host), waited on through a CUDA event.  A CPU program takes the
frames as they are.

The spans are `FrameEngine`'s, in `engine.spans`, a frame's id `(stream,
capture sequence number)`; a batched step's `d2s.dispatch` and
`d2s.finish` belong to the frames of its fresh rows, one id a row.  Each
sink gets its frame's capture time and id in `stats` (`"t0"`, `"frame"`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.pipeline.engine import Mailbox, _HostStaging, _to_host_async
from desktop2stereo_tpu_torch.pipeline import profiling
from desktop2stereo_tpu_torch.pipeline.metrics import FpsCounter
from desktop2stereo_tpu_torch.pipeline.profiling import TraceRequest, annotate


class _Stream:
    def __init__(self, idx: int, source: Any, sink: Any, device: torch.device):
        self.idx = idx
        self.source = source
        self.sink = sink
        # sink-negotiated depth (FrameEngine's contract): no device→host depth
        # copy for a sink that never reads it
        self.wants_depth = bool(getattr(sink, "wants_depth", True))
        self.staging = _HostStaging(device) if device.type == "cuda" else None
        self.raw = Mailbox()  # items (frame, frame id, t0)
        self.out = Mailbox()  # items (sbs, depth, frame id, t0)
        self.raw_seq = -1
        self.out_seq = -1
        self.captured = 0  # capture sequence numbers handed out
        # ((sbs, depth, done event, frame id, t0), its d2s.dispatch span)
        # awaiting the host
        self.pending = None
        self.frames = 0
        self.fps = FpsCounter()
        self.done = threading.Event()

    def next_frame(self) -> profiling.FrameId:
        fid = (self.idx, self.captured)
        self.captured += 1
        return fid


def _copy_out(device: torch.device, sbs: torch.Tensor, depth: Optional[torch.Tensor]):
    """(sbs, depth, event): the outputs' device→host copies into pinned
    memory and an event behind them on a CUDA program; the tensors as they
    are (and no event) on the CPU.  `depth` None: not fetched."""
    if device.type != "cuda":
        return sbs, depth, None
    sbs_h = _to_host_async(sbs)
    depth_h = None if depth is None else _to_host_async(depth)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return sbs_h, depth_h, done


def _to_numpy(sbs: torch.Tensor, depth: Optional[torch.Tensor], done) -> Tuple:
    if done is not None:
        done.synchronize()
    return sbs.numpy(), None if depth is None else depth.numpy()


class MultiStreamEngine:
    """N sources → one program (per-stream state, `program(frame,
    stream=i)`) → N sinks, the streams round-robin on one compute thread."""

    def __init__(self, sources: Sequence[Any], program, sinks: Sequence[Any],
                 target_fps: float = 60.0, shutdown: Optional[threading.Event] = None) -> None:
        if len(sources) != len(sinks):
            raise ValueError("need one sink per source")
        if getattr(program, "device", None) is None:
            raise ValueError(f"{type(self).__name__} needs a program with a `device` (the "
                             f"device its frames are staged on); {type(program).__name__} "
                             f"has none")
        self.program = program
        self.device = torch.device(program.device)
        self.target_fps = target_fps
        self.shutdown = shutdown or threading.Event()
        self.streams: List[_Stream] = [_Stream(i, src, snk, self.device)
                                       for i, (src, snk) in enumerate(zip(sources, sinks))]
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self.spans = profiling.engine_log()
        # set before start() to trace the compute thread (`--profile-dir`)
        self.trace: Optional[TraceRequest] = None

    # ---- per-stream capture / sink loops ---------------------------------

    def _capture_loop(self, st: _Stream) -> None:
        profiling.bind(self.spans)
        interval = 1.0 / self.target_fps if self.target_fps > 0 else 0.0
        try:
            while not self.shutdown.is_set():
                fid = st.next_frame()
                with annotate("d2s.grab", (fid,)) as grab:
                    frame = st.source.grab()
                if frame is None:
                    st.done.set()
                    return
                t0 = grab.start / 1e9
                st.raw.put((frame, fid, t0))
                if interval:
                    slack = interval - (time.perf_counter() - t0)
                    if slack > 0:
                        time.sleep(slack)
        except BaseException as e:  # handed to run(), which re-raises it
            self._error = e
            self.shutdown.set()

    def _sink_loop(self, st: _Stream) -> None:
        profiling.bind(self.spans)
        try:
            while not self.shutdown.is_set():
                item, st.out_seq = st.out.get(timeout=0.1, last_seq=st.out_seq)
                if item is None:
                    continue
                sbs_np, depth, fid, t0 = item
                with annotate("d2s.sink", (fid,)):
                    st.sink.push(sbs_np, depth, {"stream": st.idx, **st.fps.stats(),
                                                 "t0": t0, "frame": fid})
        except BaseException as e:  # handed to run(), which re-raises it
            self._error = e
            self.shutdown.set()

    # ---- the shared compute loop -------------------------------------------

    def _drained(self) -> bool:
        """Every source done and every raw mailbox taken (a source's last
        frame may land in the same tick as its done).  A stream that ended
        without a frame counts as drained; the JAX engine waits for its
        duration there instead."""
        return all(st.done.is_set() and max(st.raw_seq, 0) >= st.raw.latest_seq
                   for st in self.streams)

    def _dispatch(self, st: _Stream, frame: np.ndarray):
        """Upload, run, and enqueue the output copies: → (sbs, depth, event)."""
        with torch.inference_mode():
            with annotate("d2s.staging"):
                if st.staging is None:
                    # a read-only source view (the tcp source's frames) is copied
                    x = torch.from_numpy(np.require(frame, requirements="CW"))
                else:
                    x = st.staging.upload(frame)
            with annotate("d2s.call"):
                sbs, depth = self.program(x, stream=st.idx)
            return _copy_out(self.device, sbs, depth if st.wants_depth else None)

    def _finish(self, st: _Stream) -> None:
        (sbs, depth, done, fid, t0), dispatched = st.pending
        st.pending = None
        with annotate("d2s.finish", dispatched.frames):
            st.out.put((*_to_numpy(sbs, depth, done), fid, t0))
            st.frames += 1
            st.fps.tick()

    def _compute_loop(self) -> None:
        profiling.bind(self.spans)
        trace = self.trace
        try:
            if trace is not None:
                trace.begin()
            self._compute_steps(trace)
        except BaseException as e:  # handed to run(), which re-raises it
            self._error = e
            self.shutdown.set()
        finally:
            if trace is not None:
                trace.end()

    def _compute_steps(self, trace: Optional[TraceRequest]) -> None:
        """Round-robin: each stream's newest frame in turn, until every
        source is drained or shutdown."""
        while not self.shutdown.is_set():
            if trace is not None:
                trace.poll()
            if self._drained():
                break
            progressed = False
            for st in self.streams:
                item, st.raw_seq = st.raw.get(timeout=0.0, last_seq=st.raw_seq)
                if item is None:
                    # an exhausted stream's final result must not wait for
                    # the other streams to go idle
                    if st.pending is not None and st.done.is_set():
                        self._finish(st)
                    continue
                frame, fid, t0 = item
                self.spans.mark("taken", (fid,))
                with annotate("d2s.dispatch", (fid,)) as dispatched:
                    out = self._dispatch(st, frame)
                # one-frame software pipeline per stream: finish the previous
                # result while this one runs on the device
                if st.pending is not None:
                    self._finish(st)
                st.pending = ((*out, fid, t0), dispatched)
                progressed = True
            if not progressed:
                # nothing new anywhere: flush the pending results, then idle
                for st in self.streams:
                    if st.pending is not None:
                        self._finish(st)
                time.sleep(0.001)
        for st in self.streams:
            if st.pending is not None:
                self._finish(st)

    # ---- lifecycle ---------------------------------------------------------

    def preload(self, frame: Any, stream: int = 0) -> None:
        """Enqueue a frame captured before start() (the CLI's shape probe)
        into a stream's raw mailbox, so that it is processed, not lost."""
        st = self.streams[stream]
        st.raw.put((frame, st.next_frame(), time.perf_counter()))

    def start(self) -> None:
        for st in self.streams:
            for name, fn in (("capture", self._capture_loop), ("sink", self._sink_loop)):
                t = threading.Thread(target=fn, args=(st,), name=f"d2s-{name}-{st.idx}",
                                     daemon=True)
                t.start()
                self._threads.append(t)
        t = threading.Thread(target=self._compute_loop, name="d2s-compute", daemon=True)
        t.start()
        self._threads.append(t)
        self._compute_thread = t

    def run(self, duration: Optional[float] = None) -> dict:
        """Blocking: start, wait until every source is exhausted and its
        frames delivered (or `duration` seconds), stop; per-stream stats."""
        self.start()
        t0 = time.monotonic()
        try:
            while not self.shutdown.is_set():
                if not self._compute_thread.is_alive():
                    break  # all sources exhausted; the pending results flushed
                if duration is not None and time.monotonic() - t0 > duration:
                    break
                time.sleep(0.02)
        finally:
            # a bounded delivery drain: each stream's last result is taken
            # by its sink before shutdown (a taken item is always pushed: the
            # sink loop checks shutdown again only after its push)
            deadline = time.monotonic() + 5.0
            while (not self.shutdown.is_set() and time.monotonic() < deadline
                   and any(max(st.out_seq, 0) < st.out.latest_seq for st in self.streams)):
                time.sleep(0.01)
            self.shutdown.set()
            for t in self._threads:
                t.join(timeout=5.0)
        if self._error is not None:
            raise self._error
        return self.stats()

    def stats(self) -> dict:
        return {f"stream{st.idx}": {"frames": st.frames,
                                    "dropped": st.raw.dropped + st.out.dropped,
                                    **st.fps.stats()}
                for st in self.streams}


class _RowStaging:
    """Pinned [S, H, W, C] upload slots, a ring of two, for the batched
    engine: each stream's newest frame is copied straight into its row
    (a row whose slot already holds that frame is not copied again), then
    the slot goes up in one host→device copy.  A slot is rewritten only after
    the event recorded behind its last upload fired."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._slots: List[Optional[list]] = [None, None]  # [host, event, held keys]
        self._next = 0

    def upload(self, frames: Sequence[np.ndarray], keys: Sequence) -> torch.Tensor:
        i = self._next
        self._next = 1 - i
        shape = (len(frames),) + tuple(frames[0].shape)
        slot = self._slots[i]
        if slot is None or tuple(slot[0].shape) != shape:
            slot = [torch.empty(shape, dtype=torch.uint8, pin_memory=True), torch.cuda.Event(),
                    [None] * len(frames)]
            self._slots[i] = slot
        else:
            slot[1].synchronize()  # its previous upload has left the buffer
        host, event, held = slot
        rows = host.numpy()
        for r, (frame, key) in enumerate(zip(frames, keys)):
            if held[r] != key:
                rows[r] = frame
                held[r] = key
        dev = host.to(self.device, non_blocking=True)
        event.record(torch.cuda.current_stream(self.device))
        return dev


class BatchedStreamEngine(MultiStreamEngine):
    """N sources → one batch of S = N frames a launch (`program(frames
    [S,H,W,C], fresh=mask)`, a `BatchedProgramCache`) → N sinks.

    Latest-wins per stream: a stream with no new frame re-submits its
    previous one (its EMA advances, as the reference viewer re-renders a
    stale frame), marked not fresh, so that a per-stream model carry keeps
    its row, and its sink is not pushed a duplicate.  A stream that has no
    frame yet gets a stand-in row from a live stream when it has ended
    frameless, or, for a stateless program, when it has not started (a
    remote agent still connecting); a stateful program waits for it, since
    its first frame would seed that stream's carry with another stream's
    content.  Stand-ins are never pushed."""

    def __init__(self, sources, program, sinks, target_fps: float = 60.0,
                 shutdown: Optional[threading.Event] = None) -> None:
        super().__init__(sources, program, sinks, target_fps, shutdown)
        self._rows = _RowStaging(self.device) if self.device.type == "cuda" else None

    def _dispatch_batch(self, frames, keys, fresh):
        """Upload the S rows, run, and enqueue the output copies (depth only
        if some sink reads it): → (sbs, depth, event)."""
        with torch.inference_mode():
            with annotate("d2s.staging"):
                if self._rows is None:
                    batch = torch.from_numpy(np.stack(frames))
                else:
                    batch = self._rows.upload(frames, keys)
            with annotate("d2s.call"):
                sbs, depth = self.program(batch, fresh=np.asarray(fresh, bool))
            want_depth = any(st.wants_depth for st in self.streams)
            return _copy_out(self.device, sbs, depth if want_depth else None)

    def _compute_steps(self, trace: Optional[TraceRequest]) -> None:
        """One batch of every stream's newest frame a launch, until every
        source is drained or shutdown."""
        n = len(self.streams)
        last: List[Optional[np.ndarray]] = [None] * n  # newest frame per stream
        keys: List[Any] = [None] * n                   # (stream, seq) of that frame
        fresh = [False] * n
        t0s = [0.0] * n
        fids: List[Any] = [None] * n                   # that frame's id
        # ((sbs, depth, event, fresh mask, t0s, frame ids), its d2s.dispatch span)
        pending = None
        stateless = not getattr(self.program, "stateful", False)
        while not self.shutdown.is_set():
            if trace is not None:
                trace.poll()
            if self._drained():
                break
            got_any = False
            for st in self.streams:
                item, seq = st.raw.get(timeout=0.0, last_seq=st.raw_seq)
                if item is not None:
                    st.raw_seq = seq
                    last[st.idx], fids[st.idx], t0s[st.idx] = item
                    self.spans.mark("taken", (fids[st.idx],))
                    keys[st.idx] = (st.idx, seq)
                    fresh[st.idx] = True
                    got_any = True
            have = [i for i in range(n) if last[i] is not None]
            if have and len(have) < n:
                for st in self.streams:
                    if last[st.idx] is None and (st.done.is_set() or stateless):
                        last[st.idx], keys[st.idx] = last[have[0]], keys[have[0]]
            if not got_any or any(f is None for f in last):
                if pending is not None:
                    self._finish_step(pending)
                    pending = None
                time.sleep(0.001)
                continue
            shapes = {f.shape for f in last}
            if len(shapes) > 1:
                raise RuntimeError(
                    f"--batched requires uniform frame shapes across streams, got "
                    f"{sorted(shapes)}; use plain --streams for mixed resolutions")
            step = tuple(f for f, new in zip(fids, fresh) if new)
            with annotate("d2s.dispatch", step) as dispatched:
                out = self._dispatch_batch(last, keys, fresh)
            if pending is not None:
                self._finish_step(pending)
            pending = ((*out, list(fresh), list(t0s), list(fids)), dispatched)
            fresh = [False] * n
        if pending is not None:
            self._finish_step(pending)

    def _finish_step(self, pending) -> None:
        result, dispatched = pending
        with annotate("d2s.finish", dispatched.frames):
            self._finish_batch(result)

    def _finish_batch(self, pending) -> None:
        """Wait for a dispatched step, `pending` (sbs, depth, event, fresh
        mask, t0s, frame ids), and hand each fresh row to its sink thread."""
        sbs, depth, done, fresh, t0s, fids = pending
        sbs_np, depth_np = _to_numpy(sbs, depth, done)
        for st in self.streams:
            if not fresh[st.idx]:
                continue  # no duplicate pushes
            d = depth_np[st.idx] if depth_np is not None and st.wants_depth else None
            st.out.put((sbs_np[st.idx], d, fids[st.idx], t0s[st.idx]))
            st.frames += 1
            st.fps.tick()
