"""The port's profiling hooks (`pipeline/profiling.py`) on the CPU: a
torch.profiler Chrome trace with the frame program's `d2s.*` ranges, taken
on the thread that runs the frames (torch.profiler records the CPU ranges
of the thread that starts it).  The span log: `tests/test_torch_spans.py`."""

import json
import threading

import numpy as np
import pytest
import torch

from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.factory import init_random
from desktop2stereo_tpu_torch.pipeline import profiling as P
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(hidden_size=64, num_layers=2, num_heads=2, mlp_dim=128,
            out_layers=(0, 1, 1, 1), neck_channels=(16, 32, 64, 64), fusion_channels=32)
SPEC = dict(name="tiny", family="depth_anything", variant="vits", hf_repo="none")


def _names(path):
    return {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}


def test_trace_holds_the_annotated_ranges(tmp_path):
    d = P.start_trace(str(tmp_path / "t"))
    with P.annotate("d2s.outer"):
        with P.annotate("d2s.inner"):
            torch.ones(64).sum()
    path = P.stop_trace()
    assert d == str(tmp_path / "t") and path.startswith(d) and path.endswith(".json")
    assert {"d2s.outer", "d2s.inner"} <= _names(path)


def test_trace_directory_defaults_to_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("D2S_TRACE_DIR", str(tmp_path / "env"))
    with P.trace() as d:
        with P.annotate("d2s.env"):
            torch.ones(4).sum()
    assert d == str(tmp_path / "env")
    (path,) = (tmp_path / "env").glob("*.json")
    assert "d2s.env" in _names(path)


def test_trace_start_and_stop_are_paired_on_a_thread(tmp_path):
    with pytest.raises(RuntimeError, match="no trace"):
        P.stop_trace()
    P.start_trace(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            P.start_trace(str(tmp_path))
    finally:
        P.stop_trace()


def test_trace_request_records_the_worker_thread(tmp_path):
    """A worker runs the trace on itself; `finish` on the main thread stops
    it at the worker's next poll and returns the file, which holds the
    worker's ranges."""
    req = P.TraceRequest(str(tmp_path))
    started = threading.Event()

    def worker():
        req.begin()
        started.set()
        try:
            while True:
                req.poll()
                if req.path is not None:
                    return
                with P.annotate("d2s.worker"):
                    torch.ones(16).sum()
        finally:
            req.end()

    t = threading.Thread(target=worker)
    t.start()
    assert started.wait(60)
    path = req.finish(timeout=60)
    t.join(60)
    assert path is not None and "d2s.worker" in _names(path)


def test_engine_traces_its_compute_thread(tmp_path):
    """FrameEngine with a TraceRequest: the trace spans the compute thread's
    frames and holds each stage's range of the fused tail."""
    model = init_random(DepthAnything(**TINY), 0).eval()
    cfg = T_programs.ProgramConfig(
        model_name="tiny", depth_resolution=56, output_height=64, display_mode="Half-SBS",
        ipd=0.064, depth_strength=2.0, convergence=0.0, foreground_scale=0.0, aa_strength=1.0,
        ema_alpha=0.9, temporal_smooth=True, quality="high", emit_depth="model")
    prog = T_programs.ProgramCache(cfg, model, TSpec(**SPEC), compute_dtype=torch.float32)

    class Source:
        def __init__(self):
            self.frames = [np.full((64, 112, 4), 40 * i, np.uint8) for i in range(3)]

        def grab(self):
            return self.frames.pop(0) if self.frames else None

    class Sink:
        count = 0

        def push(self, sbs, depth, stats):
            Sink.count += 1

    engine = FrameEngine(Source(), prog, Sink(), target_fps=0.0)
    engine.trace = P.TraceRequest(str(tmp_path))
    engine.run(duration=60.0)
    path = engine.trace.finish(timeout=60)
    assert Sink.count >= 1 and path is not None
    assert {"d2s.preprocess", "d2s.model", "d2s.tail"} <= _names(path)
