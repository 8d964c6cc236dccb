"""What the harness records of a run, from outside the program.

The engine is driven as a user drives it; the harness only wraps what it
hands the engine or what the engine instance holds:

- the capture mailboxes (`HookedMailbox`): the capture time `t0` of each
  frame the compute thread takes, by mailbox sequence number;
- the output mailboxes: the `t0` the engine carries with each finished
  frame, read by the feed's sink as it takes the frame (the engine hands
  the sink no capture time), and the frames the mailbox drops;
- the staging upload of the engine instance (`engine._rows.upload` or
  `engine._staging.upload`): its host time, and which ring frame each row
  of the step holds (the engine copies the very arrays the sources
  handed it);
- the program object the engine calls (`TimedProgram`): the host time of
  the call, which enqueues every launch of the step, and the step's
  `fresh` rows; and, through forward hooks on the program's model
  (`StageTap`), what the call computed for the check: the encoders'
  outputs and the raw depth, with a device copy of the delivered depth,
  held for the last `RING_STEPS` calls.  A stateful program's model
  returns (raw depth, entries); for it the call also keeps the carry into
  the model call (its `caches` argument), the entries, and the carry out
  as the program holds it after the call (the next call's carry in).
  These are references, sound while the program builds a new carry every
  step.  When the sample takes a frame, its row's carry is compared there,
  on the device, with what it should be (`carry_counts`), and only its
  carry in and entries are copied;
- the sinks (`BenchSink`, which take no depth, as a display sink takes
  none): the delivery time of each frame, a check of its shape and dtype,
  and a seeded sample of the frames delivered in the window, each with
  the stages its call computed.

In a traced run each of these also opens a profiler range (`bench.staging`,
`bench.dispatch`, `bench.finish`), beside the program's own `d2s.*` ranges.
"""

from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stereobench.window import Reservoir

RANGE_STAGING = "bench.staging"
RANGE_DISPATCH = "bench.dispatch"
RANGE_FINISH = "bench.finish"
RING_STEPS = 4  # program calls whose stages stay held until their frames are delivered
CARRY_ARG = "caches"  # the argument that takes a stateful model's carry


@dataclass
class Step:
    """One call of the program: its rows' (feed, ring index, capture time)
    and which of them hold a new frame."""
    upload_s: float
    rows: List[Tuple[int, int, float]]
    t_dispatch: float = 0.0
    dispatch_s: float = 0.0
    fresh: List[bool] = field(default_factory=list)


@dataclass
class Delivery:
    feed: int
    t0: float
    t: float


class Recorder:
    def __init__(self, rings: Sequence[Sequence[np.ndarray]], sample: Reservoir,
                 batched: bool, advance=None) -> None:
        self.ring_of = {id(a): (f, i) for f, ring in enumerate(rings) for i, a in enumerate(ring)}
        self.ring_at = {a.ctypes.data: (f, i) for f, ring in enumerate(rings)
                        for i, a in enumerate(ring)}
        self.steps: List[Step] = []
        self.deliveries: List[Delivery] = []
        self.malformed: List[str] = []
        self.out_dropped: List[Tuple[int, float]] = []
        self.sample = sample
        self.batched = batched
        self.advance = advance  # a stateful family's `advance`; None for another
        self.stages: Dict[int, dict] = {}              # call index → what it computed
        self.call_of: Dict[Tuple[int, float], int] = {}  # (feed, t0) → call index
        self.window: Tuple[float, float] = (float("inf"), float("inf"))
        self._pending: Optional[Step] = None
        self._lock = threading.Lock()

    # ---- the compute thread ------------------------------------------------

    def staged(self, dt: float, rows: List[Tuple[int, int, float]]) -> None:
        self._pending = Step(dt, rows)

    def dispatched(self, t: float, dt: float, fresh: Optional[Sequence[bool]],
                   stages: dict) -> None:
        step, self._pending = self._pending, None
        if step is None:
            raise RuntimeError("the program was called without a staged frame the harness saw")
        step.t_dispatch, step.dispatch_s = t, dt
        step.fresh = [True] * len(step.rows) if fresh is None else [bool(x) for x in fresh]
        with self._lock:
            k = len(self.steps)
            self.steps.append(step)
            self.stages[k] = stages
            self.stages.pop(k - RING_STEPS, None)
            for r, ((_, _, t0), new) in enumerate(zip(step.rows, step.fresh)):
                if new:
                    self.call_of.setdefault((r, t0), k)

    def release(self) -> None:
        """Drop the held stages (the sample keeps its own)."""
        with self._lock:
            self.stages.clear()

    def _stages_of(self, feed: int, t0: float) -> Optional[dict]:
        """The stages of the call that produced feed's frame captured at t0,
        feed's row alone (copied on a batched call), and whether that call
        was the first (which starts from no EMA); of a stateful call also
        its carry's counts (`carry_counts`); None if no longer held."""
        with self._lock:
            k = self.call_of.get((feed, t0))
            cur, prev = self.stages.get(k), self.stages.get(k - 1) if k is not None else None
        if cur is None:
            return None
        if not self.batched:
            out = {"enc": cur["enc"], "raw": cur["raw"][0], "depth": cur["depth"],
                   "prev": None if prev is None else prev["depth"], "first": k == 0}
            if self.advance is not None:
                out.update(self.carry_counts(cur, prev, k, slice(None)))
            return out
        row = slice(feed, feed + 1)
        out = {"enc": {p: [t[row].clone() for t in ts] for p, ts in cur["enc"].items()},
               "raw": cur["raw"][feed].clone(), "depth": cur["depth"][feed].clone(),
               "prev": None if prev is None else prev["depth"][feed].clone(),
               "first": k == 0}
        if self.advance is not None:
            carry = self.carry_counts(cur, prev, k, row)
            for name in ("carry_in", "entries"):  # the row copied, as the encoders' outputs
                if carry[name] is not None:
                    carry[name] = tuple(t.clone() for t in carry[name])
            out.update(carry)
        return out

    def carry_counts(self, cur: dict, prev: Optional[dict], k: int, row: slice) -> dict:
        """A stateful call's carry, at `row`: its carry in (None on a first
        call) and its entries, as views, and two counts, each (values off, a
        tensor on the device, not read yet; values compared):

        - `shift`: the carry out, as the program holds it, against the
          family's `advance` of the carry in and the entries;
        - `chain`: the carry in against the carry out of the row's previous
          call, or against none on the first call (None when that call is
          no longer held).

        A carry missing where one is due, or of another form, is off in
        every value."""
        at = lambda ts: None if ts is None else tuple(t[row] for t in ts)  # noqa: E731
        c_in, entries = at(cur["carry_in"]), at(cur["entries"])
        want = self.advance(c_in, entries)
        values = sum(w.numel() for w in want)
        if k == 0:
            chain = (0, values) if c_in is None else (values, values)
        else:
            chain = None if prev is None else _off(at(prev["carry_out"]), c_in, values)
        return {"carry_in": c_in, "entries": entries,
                "shift": _off(want, at(cur["carry_out"]), values), "chain": chain}

    # ---- the sink threads --------------------------------------------------

    def delivered(self, feed: int, t0: float, t: float, sbs: np.ndarray, shape) -> None:
        bad = None
        if tuple(sbs.shape) != tuple(shape) or sbs.dtype != np.uint8:
            bad = f"feed {feed}: frame {sbs.dtype} {tuple(sbs.shape)}, want uint8 {tuple(shape)}"
        with self._lock:
            if bad is not None:
                self.malformed.append(bad)
            self.deliveries.append(Delivery(feed, t0, t))
        w0, w1 = self.window
        if w0 <= t < w1 and bad is None:
            self.sample.offer(lambda: (feed, t0, np.array(sbs), self._stages_of(feed, t0)))

    def dropped(self, feed: int, t0: float) -> None:
        with self._lock:
            self.out_dropped.append((feed, t0))


def hooked_mailbox(base, feed: int, recorder: Optional[Recorder] = None):
    """A `Mailbox` (the engine's own class, `base`) that keeps the capture
    time of what it hands out: `t0_by_seq` and `last_t0` on the taking
    thread for a capture mailbox, `taken_t0` for an output mailbox (item
    (sbs, depth, t0)); with a `recorder`, an output mailbox also reports
    each item it drops unread."""

    class HookedMailbox(base):
        def __init__(self) -> None:
            super().__init__()
            self.t0_by_seq: Dict[int, float] = {}
            self.last_t0: Optional[float] = None
            self.taken_t0: Optional[float] = None

        def put(self, item) -> None:
            if recorder is not None:
                with self._cond:
                    if self._item is not None and self._seq > self._taken_seq:
                        recorder.dropped(feed, self._item[-1])
                    super().put(item)
            else:
                super().put(item)

        def get(self, timeout=None, last_seq: int = -1):
            item, seq = super().get(timeout, last_seq)
            if item is not None:
                t0 = item[-1]
                self.t0_by_seq[seq] = t0
                self.last_t0 = self.taken_t0 = t0
            return item, seq

    return HookedMailbox()


class StageTap:
    """Forward hooks on the program's model: each call's encoder outputs
    (the modules at `paths` under `root`) and the model's raw depth, as the
    timed path computed them; of a model that returns (raw depth, entries),
    also the entries and the carry it was given (`CARRY_ARG`, None on a
    first call).  Keeps references; copies nothing."""

    def __init__(self, model: torch.nn.Module, root: torch.nn.Module,
                 paths: Sequence[str]) -> None:
        self.current: dict = {"enc": {}}
        self.handles = [root.get_submodule(p).register_forward_hook(self._encoder(p))
                        for p in paths]
        self._signature = inspect.signature(model.forward)
        self.handles.append(model.register_forward_hook(self._raw, with_kwargs=True))

    def _encoder(self, path: str):
        def hook(module, args, out):
            self.current["enc"][path] = list(out)
        return hook

    def _raw(self, module, args, kwargs, out) -> None:
        if isinstance(out, tuple):  # a stateful model: (raw depth, entries)
            out, self.current["entries"] = out
            self.current["carry_in"] = self._signature.bind(*args, **kwargs).arguments.get(
                CARRY_ARG)
        self.current["raw"] = out

    def take(self) -> dict:
        cur, self.current = self.current, {"enc": {}}
        return cur

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class TimedProgram:
    """The program as the engine sees it: each call timed on the host and
    recorded, inside a `bench.dispatch` range, with what its `tap` saw and
    a device copy of the depth it returned."""

    def __init__(self, program, recorder: Recorder, tap: StageTap) -> None:
        self.program = program
        self.recorder = recorder
        self.tap = tap
        self.device = program.device
        self.stateful = getattr(program, "stateful", False)
        self.cpu_box = None  # the one-feed engine's capture mailbox, on a CPU program

    def __getattr__(self, name):
        return getattr(self.program, name)

    def __call__(self, frames, *args, **kwargs):
        rec = self.recorder
        if rec._pending is None and self.cpu_box is not None:
            # the one-feed engine has no staging on the CPU: it hands the
            # program the ring's own memory
            f, i = rec.ring_at[frames.data_ptr()]
            rec.staged(0.0, [(f, i, self.cpu_box.last_t0)])
        t = time.perf_counter()
        with torch.profiler.record_function(RANGE_DISPATCH):
            sbs, depth = self.program(frames, *args, **kwargs)
        dt = time.perf_counter() - t
        stages = self.tap.take()
        stages["depth"] = depth.clone()
        if self.stateful:
            stages["carry_out"] = held_carry(self.program)
        rec.dispatched(t, dt, kwargs.get("fresh"), stages)
        return sbs, depth


def _off(want, got, values: int):
    """(values of the carry `got` not bit-equal to `want`, `values`)."""
    if not want or not got or [w.shape for w in want] != [g.shape for g in got]:
        return values, values
    return sum((g != w).sum() for w, g in zip(want, got)), values


def held_carry(program) -> tuple:
    """The model carry a `ProgramCache` or `BatchedProgramCache` holds for
    the one frame size a run sends (`()` where it holds none)."""
    states = list(program._states.values())
    if len(states) != 1:
        raise RuntimeError(f"the program holds {len(states)} states; a run sends one frame size")
    return tuple(states[0].model)


class BenchSink:
    """Takes each frame without its depth (as a display sink does), checks
    the frame's shape and dtype, and records the delivery."""

    wants_depth = False

    def __init__(self, feed: int, recorder: Recorder, shape) -> None:
        self.feed, self.recorder, self.shape = feed, recorder, tuple(shape)
        self.box = None  # the feed's output mailbox, set by `install`

    def push(self, sbs, depth, stats) -> None:
        self.recorder.delivered(self.feed, self.box.taken_t0, time.perf_counter(), sbs,
                                self.shape)


class _CpuRows:
    """The batched engine's staging on a CPU program (which has none): the
    rows stacked as they are, so that the upload hook sees them too."""

    def upload(self, frames, keys):
        return torch.from_numpy(np.stack(frames))


def install(engine, recorder: Recorder) -> None:
    """Hook a `BatchedStreamEngine` or a `FrameEngine` made with a
    `TimedProgram` and `BenchSink`s, before it starts."""
    from desktop2stereo_tpu_torch.pipeline.engine import Mailbox

    if hasattr(engine, "streams"):  # the multi-stream engines
        for st in engine.streams:
            st.raw = hooked_mailbox(Mailbox, st.idx)
            st.out = hooked_mailbox(Mailbox, st.idx, recorder)
            st.sink.box = st.out
        if engine._rows is None:
            engine._rows = _CpuRows()
        upload = engine._rows.upload
        raws = [st.raw for st in engine.streams]

        def staged_upload(frames, keys):
            t = time.perf_counter()
            with torch.profiler.record_function(RANGE_STAGING):
                out = upload(frames, keys)
            dt = time.perf_counter() - t
            rows = []
            for frame, (feed, seq) in zip(frames, keys):
                f, i = recorder.ring_of[id(frame)]
                rows.append((f, i, raws[feed].t0_by_seq[seq]))
            recorder.staged(dt, rows)
            return out

        engine._rows.upload = staged_upload
        _wrap_finish(engine, "_finish_batch")
        return

    engine.raw_box = hooked_mailbox(Mailbox, 0)
    engine.out_box = hooked_mailbox(Mailbox, 0, recorder)
    engine.sink.box = engine.out_box
    if engine._staging is not None:
        upload = engine._staging.upload
        raw = engine.raw_box

        def staged_upload(frame):
            t = time.perf_counter()
            with torch.profiler.record_function(RANGE_STAGING):
                out = upload(frame)
            f, i = recorder.ring_of[id(frame)]
            recorder.staged(time.perf_counter() - t, [(f, i, raw.last_t0)])
            return out

        engine._staging.upload = staged_upload
    else:
        engine.program.cpu_box = engine.raw_box
    _wrap_finish(engine, "_finish")


def _wrap_finish(engine, name: str) -> None:
    finish = getattr(engine, name)

    def wrapped(*args):
        with torch.profiler.record_function(RANGE_FINISH):
            return finish(*args)

    setattr(engine, name, wrapped)


class SliceTrace:
    """The engine's `trace` hook (`pipeline/profiling.py:TraceRequest`'s
    protocol: `begin`, `poll`, `end`, all on the compute thread), running
    `torch.profiler` only between `start_at` and `stop_at` requests.  Made
    on the main thread, it first runs an empty profile there: the
    profiler's first start sets up CUPTI, which takes seconds."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            self._activities.append(ProfilerActivity.CUDA)
        with profile(activities=self._activities):
            pass
        self.want_start = threading.Event()
        self.want_stop = threading.Event()
        self.done = threading.Event()
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None

    def begin(self) -> None:
        pass

    def poll(self) -> None:
        if self.prof is None and self.want_start.is_set() and not self.done.is_set():
            from torch.profiler import profile

            self.prof = profile(activities=self._activities)
            self.prof.start()
            self.t_start = time.perf_counter()
        elif self.prof is not None and self.want_stop.is_set():
            self.end()

    def end(self) -> None:
        if self.prof is not None and self.t_stop is None:
            self.t_stop = time.perf_counter()
            self.prof.stop()
        self.done.set()
