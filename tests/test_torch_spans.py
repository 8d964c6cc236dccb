"""The port's span log (`pipeline/profiling.py`) on the CPU: the ring, the
frame ids and nesting, the engines' per-frame spans (whose parts add up to
each frame's latency), the capture time and frame id handed to the sink,
the `d2s.clock` range that places spans on a profiler trace, the module
ranges that exist only while a profiler runs, the set-up spans, the
engine's `stats()["latency"]`, the CLI's span export and the kernel
libraries' count of captured launches."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.factory import init_random
from desktop2stereo_tpu_torch.ops.kernels import build as B
from desktop2stereo_tpu_torch.pipeline import profiling as P
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
from desktop2stereo_tpu_torch.pipeline.multi import BatchedStreamEngine, MultiStreamEngine
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(hidden_size=64, num_layers=2, num_heads=2, mlp_dim=128,
            out_layers=(0, 1, 1, 1), neck_channels=(16, 32, 64, 64), fusion_channels=32)
SPEC = dict(name="tiny", family="depth_anything", variant="vits", hf_repo="none")
CFG = dict(model_name="tiny", depth_resolution=56, output_height=64, display_mode="Half-SBS",
           ipd=0.064, depth_strength=2.0, convergence=0.0, foreground_scale=0.0,
           aa_strength=1.0, ema_alpha=0.9, temporal_smooth=True, quality="high",
           emit_depth="model")
SHAPE = (64, 112, 4)
PARTS = ("d2s.grab", "taken", "d2s.dispatch", "d2s.finish", "d2s.sink")


@pytest.fixture(scope="module")
def model():
    return init_random(DepthAnything(**TINY), 0).eval()


def _cache(model):
    return T_programs.ProgramCache(T_programs.ProgramConfig(**CFG), model, TSpec(**SPEC),
                                   compute_dtype=torch.float32)


class _Source:
    """`n` frames; once given the engine's capture mailbox (`box`), each
    after the one before it was taken, so that none is superseded."""

    def __init__(self, n, seed=0):
        self.frames = [np.full(SHAPE, (40 * i + seed) % 256, np.uint8) for i in range(n)]
        self.box = None

    def grab(self):
        if self.box is not None:
            assert self.box.wait_taken(60)
        return self.frames.pop(0) if self.frames else None


class _Sink:
    """Records each push's stats and its own clock."""

    def __init__(self):
        self.pushes = []

    def push(self, sbs, depth, stats):
        self.pushes.append((time.perf_counter(), stats))


def _first_spans(log):
    """{frame id: {part name: its first span}}."""
    out = {}
    for s in log.spans():
        if s.name in PARTS:
            for f in s.frames:
                out.setdefault(f, {}).setdefault(s.name, s)
    return out


def _check_parts(log, sinks):
    """Each pushed frame has every part; the parts add up to the sink's start
    less the capture, and to the sink's own clock less `t0` within 50 ms."""
    by_frame = _first_spans(log)
    split = {tuple(r["frame"]): r for r in P.frame_split(log.spans())}
    pushed = 0
    for sink in sinks:
        for t_push, stats in sink.pushes:
            fid = stats["frame"]
            parts = by_frame[fid]
            assert set(parts) == set(PARTS)
            t0 = parts["d2s.grab"].start
            queue = parts["taken"].start - t0
            dispatch = parts["d2s.dispatch"].end - parts["taken"].start
            held = parts["d2s.finish"].start - parts["d2s.dispatch"].end
            deliver = parts["d2s.sink"].start - parts["d2s.finish"].start
            assert min(queue, dispatch, held, deliver) >= 0
            assert queue + dispatch + held + deliver == parts["d2s.sink"].start - t0
            assert stats["t0"] == pytest.approx(t0 / 1e9, abs=1e-6)
            lat = t_push - stats["t0"]
            assert 0 <= lat - (queue + dispatch + held + deliver) / 1e9 < 0.05
            row = split[fid]
            assert row["latency_ms"] == pytest.approx(
                row["queue_ms"] + row["dispatch_ms"] + row["held_ms"] + row["deliver_ms"])
            pushed += 1
    assert pushed >= 2


def test_ring_stays_bounded():
    log = P.SpanLog(capacity=8)
    for i in range(20):
        with P.annotate(f"d2s.s{i}", ((0, i),), log=log):
            pass
    spans = log.spans()
    assert len(spans) == 8
    assert [s.name for s in spans] == [f"d2s.s{i}" for i in range(12, 20)]


def test_spans_of_a_frame_share_its_id_and_nest():
    """Children take their parent's frames and id; two threads nest apart."""
    log = P.SpanLog()

    def frame(fid):
        with P.annotate("d2s.dispatch", (fid,), log=log) as outer:
            log.mark("taken", (fid,))
            with P.annotate("d2s.call", log=log) as call:
                with P.annotate("d2s.model", log=log) as inner:
                    time.sleep(0.001)
        assert call.parent == outer.id and inner.parent == call.id and outer.parent == 0
        assert outer.start <= call.start <= inner.start <= inner.end <= call.end <= outer.end

    threads = [threading.Thread(target=frame, args=((f, 0),)) for f in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    by_id = {s.id: s for s in log.spans()}
    for f in range(2):
        mine = [s for s in log.spans() if s.frames == ((f, 0),)]
        assert sorted(s.name for s in mine) == ["d2s.call", "d2s.dispatch", "d2s.model", "taken"]
        assert len({s.thread for s in mine}) == 1
        for s in mine:
            assert s.parent == 0 or by_id[s.parent].frames == s.frames


def test_frame_engine_parts_add_up_to_each_frames_latency(model):
    sink, source = _Sink(), _Source(8)
    engine = FrameEngine(source, _cache(model), sink, target_fps=60.0)
    source.box = engine.raw_box
    engine.run(duration=60.0)
    _check_parts(engine.spans, [sink])
    assert engine.spans in P.recent_engine_logs()


def test_batched_engine_parts_add_up_to_each_frames_latency(model):
    prog = T_programs.BatchedProgramCache(T_programs.ProgramConfig(**CFG), model, TSpec(**SPEC),
                                          compute_dtype=torch.float32, num_streams=2)
    sinks, sources = [_Sink(), _Sink()], [_Source(6), _Source(6, seed=7)]
    engine = BatchedStreamEngine(sources, prog, sinks, target_fps=60.0)
    for src, st in zip(sources, engine.streams):
        src.box = st.raw
    engine.run(duration=60.0)
    _check_parts(engine.spans, sinks)
    steps = [s for s in engine.spans.spans() if s.name == "d2s.dispatch"]
    assert any(len(s.frames) == 2 for s in steps)  # one id a fresh row
    assert {f[0] for s in steps for f in s.frames} == {0, 1}


def test_round_robin_engine_parts_add_up_to_each_frames_latency(model):
    sinks, sources = [_Sink(), _Sink()], [_Source(5), _Source(5, seed=7)]
    engine = MultiStreamEngine(sources, _cache(model), sinks, target_fps=60.0)
    for src, st in zip(sources, engine.streams):
        src.box = st.raw
    engine.run(duration=60.0)
    _check_parts(engine.spans, sinks)


def test_sinks_receive_the_capture_time_and_frame_id(model):
    sink, source = _Sink(), _Source(4)
    engine = FrameEngine(source, _cache(model), sink, target_fps=60.0)
    source.box = engine.raw_box
    engine.run(duration=60.0)
    assert len(sink.pushes) >= 2  # the output mailbox may supersede one
    grabs = {s.frames[0]: s for s in engine.spans.spans() if s.name == "d2s.grab"}
    seen = [stats["frame"] for _, stats in sink.pushes]
    assert seen == sorted(seen) and len(set(seen)) == len(seen)
    for _, stats in sink.pushes:
        assert stats["frame"][0] == 0
        assert stats["t0"] == grabs[stats["frame"]].start / 1e9
        assert {"fps", "latency", "frames", "dropped"} <= set(stats)


def test_stats_latency_keeps_its_keys(model):
    sink = _Sink()
    engine = FrameEngine(_Source(4), _cache(model), sink, target_fps=60.0)
    final = engine.run(duration=60.0)
    lat = engine.stats()["latency"]
    assert set(lat) == {"capture", "depth+compose", "sink"}
    assert all(v > 0 for v in lat.values()) and final.latency == lat
    assert not hasattr(final, "latency_median")


def _traced_offsets(cache, frame, path):
    """Six frames' ranges under a CPU profiler, on the test's thread: each
    d2s.* range after the `d2s.clock` range with its span's start and end
    less the range's, µs, once the clock's offset is added."""
    from torch.profiler import ProfilerActivity, profile

    log = P.SpanLog()
    P.bind(log)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(6):
                with P.annotate("d2s.dispatch", ((0, i),)):
                    with P.annotate("d2s.call"):
                        cache(frame)
                with P.annotate("d2s.finish", ((0, i),)):
                    pass
    finally:
        P.bind(None)
    cache(frame)  # the first frame after the profiler removes the module hooks
    assert not cache.program.ranges.hooked
    prof.export_chrome_trace(path)
    events = [e for e in json.loads(open(path).read())["traceEvents"]
              if e.get("cat") == "user_annotation" and str(e.get("name")).startswith("d2s.")]
    offset = P.clock_offset_us(log, events)
    assert offset is not None and len(log.clocks) == 1
    clock_ts = max(e["ts"] for e in events if e["name"] == P.CLOCK)
    ranges = sorted((e for e in events if e["name"] != P.CLOCK and e["ts"] >= clock_ts),
                    key=lambda e: e["ts"])
    spans = sorted((s for s in log.spans() if s.start >= log.clocks[-1].start),
                   key=lambda s: s.start)
    assert [e["name"] for e in ranges] == [s.name for s in spans]
    assert {"d2s.model", "d2s.model/backbone", "d2s.tail", "d2s.finish"} <= {s.name for s in spans}
    return [(e["name"], s.start / 1e3 + offset - e["ts"],
             s.end / 1e3 + offset - (e["ts"] + e["dur"])) for e, s in zip(ranges, spans)]


def test_trace_ranges_lie_on_their_spans_after_the_clock(model, tmp_path):
    """Under a CPU profiler, every d2s.* range after the `d2s.clock` range
    lies within 50 µs of its span, start and end, once the clock's offset
    is added (the first frame's ranges carry the profiler's set-up on the
    thread, and the clock opens at the second frame).  A host that
    deschedules the thread between a span's stamp and its range's spoils
    one trace, not three: the test takes the first of three traces in
    which every range lies within the bound."""
    cache = _cache(model)
    frame = torch.from_numpy(_Source(1).frames[0])
    worst = []
    for attempt in range(3):
        offsets = _traced_offsets(cache, frame, str(tmp_path / f"trace{attempt}.json"))
        worst.append(max(offsets, key=lambda o: max(abs(o[1]), abs(o[2]))))
        if all(abs(a) < 50 and abs(b) < 50 for _, a, b in offsets):
            return
    pytest.fail(f"a range more than 50 µs from its span in each trace: {worst}")


def test_module_ranges_exist_only_while_a_profiler_runs(model):
    from torch.profiler import ProfilerActivity, profile

    cache = _cache(model)
    ranges = cache.program.ranges
    frame = torch.from_numpy(_Source(1).frames[0])

    def hooks():
        return sum(len(m._forward_pre_hooks) + len(m._forward_hooks) for _, m in ranges.targets())

    cache(frame)
    assert not ranges.hooked and hooks() == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cache(frame)
        assert ranges.hooked and hooks() == 2 * len(list(ranges.targets()))
    names = {e.name for e in prof.events()}
    assert {f"d2s.model/{p}" for p, _ in ranges.targets()} <= names
    cache(frame)
    assert not ranges.hooked and hooks() == 0
    # a live switch builds a new FrameProgram on the same ranges
    cache.set_display_mode("Full-SBS")
    cache(frame)
    assert cache.program.ranges is ranges


def test_module_ranges_close_what_an_exception_left_open():
    log = P.SpanLog()

    class Boom(torch.nn.Module):
        def forward(self, x):
            raise ValueError("boom")

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ok = torch.nn.Identity()
            self.blocks = torch.nn.ModuleList([Boom()])

        def forward(self, x):
            return self.blocks[0](self.ok(x))

    net = Net()
    ranges = P.ModuleRanges(net)
    assert [p for p, _ in ranges.targets()] == ["ok", "blocks.0"]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with P.annotate("d2s.model", ((0, 0),), log=log), ranges:
                P.bind(log)
                try:
                    net(torch.ones(1))
                finally:
                    P.bind(None)
    names = sorted(s.name for s in log.spans())
    assert names == ["d2s.model", "d2s.model/blocks.0", "d2s.model/ok"]
    assert log._thread().stack == []


def test_set_up_spans_are_recorded(model, monkeypatch):
    before = {s.id for s in P.PROCESS_LOG.spans()}
    report = _cache(model).warmup(SHAPE)
    new = [s for s in P.PROCESS_LOG.spans() if s.id not in before]
    (whole,) = [s for s in new if s.name == "d2s.setup.warmup"]
    stages = {s.name: s for s in new if s.parent == whole.id}
    assert set(stages) == {"d2s.setup.warmup.pre", "d2s.setup.warmup.model",
                           "d2s.setup.warmup.tail"}
    assert report == {f"{n.rsplit('.', 1)[1]}_s": s.seconds for n, s in stages.items()}
    assert all(whole.start <= s.start <= s.end <= whole.end for s in stages.values())

    from desktop2stereo_tpu_torch.ops.kernels import attention, dibr, dibr_fill, quant_matmul, warp

    for k in (attention, dibr, dibr_fill, quant_matmul, warp):
        monkeypatch.setattr(k.KERNEL, "_lib", object())  # loaded: nothing to build
    B.build_all()
    assert P.PROCESS_LOG.spans()[-1].name == "d2s.setup.kernels"


def test_captured_launches_are_counted_apart(monkeypatch):
    lib = B.CudaLibrary("attention.cu", {"d2s_entry": []})

    class Fake:
        @staticmethod
        def d2s_entry():
            return 0

    lib._lib = Fake()
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    lib.call("d2s_entry")
    capturing[0] = True
    lib.call("d2s_entry")
    lib.call("d2s_entry")
    assert lib.entry_launches == {"d2s_entry": 1} and lib.launches == 1
    assert lib.captured_launches == {"d2s_entry": 2}
    lib.launches = 0
    assert lib.entry_launches == {} and lib.captured_launches == {}


def test_export_writes_the_log_beside_the_trace(tmp_path):
    log = P.SpanLog()
    fid = (0, 3)
    with P.annotate("d2s.grab", (fid,), log=log):
        pass
    log.mark("taken", (fid,))
    for name in ("d2s.dispatch", "d2s.finish", "d2s.sink"):
        with P.annotate(name, (fid,), log=log):
            pass
    log.clocks.append(P.Span(99, P.CLOCK, 5_000_000, 5_000_000, 1, (fid,), 0))
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"cat": "user_annotation", "name": P.CLOCK, "ts": 12_000.0, "dur": 1.0}]}))
    out = json.loads(open(P.export_spans(log, str(trace))).read())
    assert out["clock_offset_us"] == 12_000.0 - 5_000.0
    assert [s["name"] for s in out["spans"]] == ["d2s.grab", "taken", "d2s.dispatch",
                                                 "d2s.finish", "d2s.sink"]
    (row,) = out["frames"]
    assert row["frame"] == [0, 3] and row["latency_ms"] >= 0
