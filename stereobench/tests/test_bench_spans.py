"""The readers of the program's spans and of the trace's runtime calls, on
synthetic spans and trace events, and on a program without spans (each
reads None)."""

from types import SimpleNamespace

import pytest

from stereobench import manifest
from stereobench import spans as S
from stereobench.record import RANGE_DISPATCH
from stereobench.tests.bench_helpers import ROOT
from stereobench.trace import TraceSlice

MS = 1_000_000  # ns


def _read(name, run):
    return manifest.metric_reader(name, ROOT)(run)


def _frame(i, t0):
    """One frame's five parts (ns): queue 5 ms, dispatch 100 ms (of it 8 ms
    staging), held 20 ms, deliver 1 ms."""
    f = ((0, i),)
    return [("d2s.grab", t0, t0 + MS, f), ("taken", t0 + 5 * MS, t0 + 5 * MS, f),
            ("d2s.dispatch", t0 + 5 * MS, t0 + 105 * MS, f),
            ("d2s.staging", t0 + 5 * MS, t0 + 13 * MS, f),
            ("d2s.finish", t0 + 125 * MS, t0 + 125 * MS + 500_000, f),
            ("d2s.sink", t0 + 126 * MS, t0 + 127 * MS, f)]


def _run(**kw):
    return SimpleNamespace(**{"window": (10.0, 12.0), "profiled_from": 11.5, "slice": None, **kw})


@pytest.fixture
def frames(monkeypatch):
    """Frames captured every 100 ms from 9.9 s: delivered from 10.026 s."""
    spans = [s for i in range(30) for s in _frame(i, int(9.9e9) + i * 100 * MS)]
    spans.append(("d2s.grab", int(20e9), int(20e9) + MS, ((0, 99),)))  # never delivered
    monkeypatch.setattr(S, "engine_spans", lambda: (spans, [int(9.9e9)]))
    return spans


def test_engine_medians_over_the_window_before_the_profiler(frames):
    run = _run()
    assert _read("engine.queue_ms", run) == pytest.approx(5.0)
    assert _read("engine.held_ms", run) == pytest.approx(20.0)
    assert _read("engine.deliver_ms", run) == pytest.approx(1.0)
    parts = S.window_frames(run, frames)
    # delivered at 10.026 + 0.1 k s before the profiler's start, 11.5 s
    assert len(parts) == 15
    assert _read("engine.held_ms", _run(window=(30.0, 31.0), profiled_from=None)) is None


def test_readers_of_spans_read_none_without_them(monkeypatch):
    monkeypatch.setattr(S, "_profiling", lambda: None)
    run = _run()
    for name in ("engine.queue_ms", "engine.held_ms", "engine.deliver_ms",
                 "engine.ready_wait_ms", "setup.kernels_s", "setup.warmup_s"):
        assert _read(name, run) is None
    # an older program: the module is there, without span logs
    monkeypatch.setattr(S, "_profiling", lambda: SimpleNamespace())
    assert _read("engine.queue_ms", run) is None and _read("setup.warmup_s", run) is None


def _ev(cat, name, ts, dur, tid=1, **args):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if args:
        e["args"] = args
    return e


def synthetic_trace(offset=1000.0):
    """Five steps of 1000 µs from `offset` on the trace: a bench.dispatch and
    a d2s.dispatch range, stage ranges holding three launches (the tail's
    kernel ends at +480 µs) and a 40 µs cudaStreamSynchronize, a launch
    outside any stage, and one on another thread inside a stage's time."""
    ev = [_ev("user_annotation", S.CLOCK, offset - 50.0, 1.0)]
    corr = 0
    for i in range(5):
        t = offset + 1000.0 * i
        ev += [_ev("user_annotation", RANGE_DISPATCH, t, 500.0),
               _ev("user_annotation", "d2s.dispatch", t, 520.0),
               _ev("user_annotation", "d2s.preprocess", t + 10, 40.0),
               _ev("user_annotation", "d2s.model", t + 60, 300.0),
               _ev("user_annotation", "d2s.tail", t + 370, 100.0)]
        for at, kt, kd in ((t + 20, t + 100, 50.0), (t + 70, t + 300, 100.0),
                           (t + 380, t + 450, 30.0)):
            corr += 1
            ev += [_ev("cuda_runtime", "cudaLaunchKernel", at, 5.0, correlation=corr),
                   _ev("kernel", "k", kt, kd, tid=7, correlation=corr)]
        ev += [_ev("cuda_runtime", "cudaStreamSynchronize", t + 200, 40.0),
               _ev("cuda_runtime", "cudaLaunchKernel", t + 600, 5.0, correlation=999),
               _ev("cuda_driver", "cuLaunchKernel", t + 100, 5.0, tid=2)]
    return ev


def test_launches_and_blocking_calls_a_step():
    s = TraceSlice(synthetic_trace(), [0.0] * 5, warm=1)
    run = _run(slice=s)
    # the slice: steps 1-3 (from 2000 to 5000 µs): three launches a step in
    # stage ranges on the compute thread
    assert _read("program.launches", run) == pytest.approx(3.0)
    assert _read("program.blocked_ms", run) == pytest.approx(0.040)
    # a trace without runtime calls has neither
    bare = [e for e in synthetic_trace() if e["cat"] not in S.RUNTIME_CATS]
    assert _read("program.launches", _run(slice=TraceSlice(bare, [0.0] * 5, warm=1))) is None
    assert _read("program.blocked_ms", _run(slice=TraceSlice(bare, [0.0] * 5, warm=1))) is None


def test_ready_wait_places_the_spans_by_the_clock(monkeypatch):
    """The log's clock stamp is 7 ms on the host and the trace's clock range
    starts at 950 µs, so a span lies at its host µs less 6050 on the trace.
    Step i's d2s.dispatch span starts at trace 1000 + 1000 i and its finish
    900 µs later; the device work of the calls inside the dispatch ends at
    +480 µs (the tail's kernel), so each frame waits 420 µs."""
    clock_host_ns = 7_000_000
    offset = 950.0 - clock_host_ns / 1e3

    def host_ns(trace_us):
        return int(round((trace_us - offset) * 1e3))

    spans = []
    for i in range(5):
        t = 1000.0 + 1000.0 * i
        f = ((0, i),)
        spans += [("d2s.grab", host_ns(t - 10), host_ns(t - 9), f),
                  ("taken", host_ns(t), host_ns(t), f),
                  ("d2s.dispatch", host_ns(t), host_ns(t + 520), f),
                  ("d2s.finish", host_ns(t + 900), host_ns(t + 910), f),
                  ("d2s.sink", host_ns(t + 920), host_ns(t + 930), f)]
    monkeypatch.setattr(S, "engine_spans", lambda: (spans, [clock_host_ns]))
    s = TraceSlice(synthetic_trace(), [0.0] * 5, warm=1)
    assert _read("engine.ready_wait_ms", _run(slice=s)) == pytest.approx(0.420)
    # no d2s.clock range in the trace: no placement, no number
    unclocked = [e for e in synthetic_trace() if e["name"] != S.CLOCK]
    assert _read("engine.ready_wait_ms",
                 _run(slice=TraceSlice(unclocked, [0.0] * 5, warm=1))) is None


def test_set_up_seconds_from_the_process_log(monkeypatch):
    from desktop2stereo_tpu_torch.pipeline import profiling as P

    log = P.SpanLog()
    for name, (a, b) in (("d2s.setup.kernels", (0, 250 * MS)),
                         ("d2s.setup.warmup", (300 * MS, 4300 * MS)),
                         ("d2s.setup.warmup.model", (300 * MS, 3000 * MS))):
        log._ring.append(P.Span(len(log._ring) + 1, name, a, b, 1, (), 0))
    monkeypatch.setattr(P, "PROCESS_LOG", log)
    assert _read("setup.kernels_s", _run()) == pytest.approx(0.25)
    assert _read("setup.warmup_s", _run()) == pytest.approx(4.0)


def test_engine_spans_reads_the_programs_newest_engine(monkeypatch):
    from desktop2stereo_tpu_torch.pipeline import profiling as P

    monkeypatch.setattr(P, "_ENGINE_LOGS", type(P._ENGINE_LOGS)(maxlen=4))
    assert S.engine_spans() is None
    log = P.engine_log()
    with P.annotate("d2s.dispatch", ((0, 1),), log=log):
        pass
    log.clocks.append(P.Span(9, P.CLOCK, 123, 123, 1, (), 0))
    spans, clocks = S.engine_spans()
    assert [s[0] for s in spans] == ["d2s.dispatch"] and spans[0][3] == ((0, 1),)
    assert clocks == [123]
