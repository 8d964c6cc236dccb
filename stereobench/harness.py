"""One run of one cell: set-up, the measured window, the traced slice, and
the check that decides `correct`.

Set-up (counted in `setup_s`, from the process's start to the window's):
the kernels built or loaded from the checkout's cache, the cell's weights
drawn on the device from the seed and loaded through the program's
`load_state_dict`, each feed's ring of frames, the program's own warm-up
of the cell's one frame shape, the engine started with the harness's sinks
and hooks, and a lead-in whose frames are not counted.  The window then
runs for `seconds`; frames dispatched in it are awaited after it closes.
A traced run profiles the window's last `trace_slice_s` seconds on the
engine's compute thread.  Once the engine has stopped and the peak memory
is read, the program is freed and the reference checks, stage by stage, a
seeded sample of the frames the window delivered (`check.py`).
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from stereobench import check, manifest, record, traffic, weights
from stereobench.trace import TraceSlice, load as load_trace
from stereobench.window import Reservoir

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
GRACE_S = 60.0  # how long after the window its frames may still arrive


@dataclass
class RunView:
    """What a metric reader reads (`metrics/<name>.py`)."""
    cell: "manifest.Cell"
    seconds: float
    window: Tuple[float, float]
    setup_s: float
    steps: list
    deliveries: list
    profiled_from: Optional[float]       # host time the profiler started, if traced
    slice: Optional[TraceSlice]
    model_flops_per_frame: float
    attention_shapes: List[Tuple[int, int, int, int]]  # one model call's
    tail: Tuple[int, int, int]           # (frames a tail call, eye h, eye w)
    device_name: str


def process_start() -> float:
    """The process's start on the `time.perf_counter` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        started = btime + ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - (time.time() - started)
    except (OSError, ValueError, IndexError, StopIteration):
        return time.perf_counter()


def _sleep_until(t: float) -> None:
    while (dt := t - time.perf_counter()) > 0:
        time.sleep(min(dt, 0.05))


def model_counts(family, cfg: dict, out_hw, batch: int):
    """(model FLOPs a frame, attention shapes of one call at `batch`),
    counted on the meta device from the reference's shapes.  Of a stateful
    family, one streaming step with a full window, its temporal modules
    counted by `roofline.temporal_ops`."""
    from torch.utils.flop_counter import FlopCounterMode

    from stereobench.reference import vit
    from stereobench.roofline import temporal_ops

    with torch.device("meta"):
        ref = family.build(cfg)
        mh, mw = family.model_input_size(cfg, *out_hw)
        x = torch.empty(1, 3, mh, mw)
        counter = FlopCounterMode(display=False)
        if getattr(family, "STATEFUL", False):  # the temporal modules by their own count
            temporal = temporal_step(family, ref, x, counter)
            modules = {f"{type(ref).__name__}.{name}" for name, m in ref.named_modules()
                       if isinstance(m, family.TemporalModule)}
            counted = sum(sum(ops.values()) for name, ops in counter.get_flop_counts().items()
                          if name in modules)
            flops = float(counter.get_total_flops() - counted + temporal_ops(temporal))
        else:
            with counter:
                ref(x)
            flops = float(counter.get_total_flops())
        with vit.record_attention() as shapes:
            ref(torch.empty(batch, 3, mh, mw))
    return flops, list(shapes)


def temporal_step(family, ref, x, counter=None) -> List[Tuple[int, int, int, int]]:
    """One streaming step of a stateful reference with a full window (under
    `counter`, where given); → its temporal modules' (B, P, n, C)."""
    _, entries = ref(x)
    carry = family.advance(None, entries)
    with counter or contextlib.nullcontext(), family.record_temporal() as temporal:
        ref(x, carry)
    return temporal


def build_program(cell, state: Dict[str, torch.Tensor], device, dtype, control: str = "none"):
    """(the cell's program, its model, the module under which the model's
    encoders sit): the port's model from the drawn weights; with a
    `control`, the check's control in the program's place: "int8", the
    program's int8 encoder, or "fp8-reference" (`control.py`)."""
    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.models.factory import FAMILIES, QUANT_SCOPES
    from desktop2stereo_tpu_torch.ops.quant import quantize_state_dict
    from desktop2stereo_tpu_torch.pipeline import programs

    cfg, mix = cell.config, cell.mix
    spec = get_spec(cfg["model"])
    make = FAMILIES[spec.family][0]
    root = None
    if control == "fp8-reference":
        from stereobench.control import fp8_reference

        model = fp8_reference(manifest.family(cfg, cell.root), cfg, state, device)
        root = model.ref
    elif control == "int8":  # as the program's factory builds it
        model = make(spec, quant=True)
        model.load_state_dict(quantize_state_dict(
            {k: v.float().cpu() for k, v in state.items()},
            QUANT_SCOPES.get(spec.family, "backbone")), strict=True)
        model = model.to(device=device, dtype=dtype)
    else:
        with torch.device("meta"):
            model = make(spec).to(dtype)
        model = model.to_empty(device=device)
        model.load_state_dict(state, strict=True)
    model.eval()
    d = cfg["display"]
    pc = programs.ProgramConfig(
        model_name=cfg["model"], depth_resolution=cfg["depth_resolution"],
        output_height=mix["frame"][0], display_mode=d["mode"], ipd=d["ipd"],
        depth_strength=d["depth_strength"], convergence=d["convergence"],
        foreground_scale=d["foreground_scale"], aa_strength=d["aa_strength"],
        ema_alpha=d["ema_alpha"], temporal_smooth=d["temporal_smooth"], quality=d["quality"],
        emit_depth=d["emit_depth"])
    root = model if root is None else root
    if mix["engine"] == "batched":
        return programs.BatchedProgramCache(pc, model, spec, compute_dtype=dtype,
                                            num_streams=mix["feeds"]), model, root
    if mix["feeds"] != 1:
        raise ValueError("the single engine takes one feed")
    return programs.ProgramCache(pc, model, spec, compute_dtype=dtype), model, root


def run_cell(cell, seed: int, seconds: float, traced: bool, device: torch.device,
             t_process: float, control: str = "none") -> dict:
    """One run (of the program, of a `control` in its place, see
    `build_program`, or of the program with a fault of `faults.py`
    planted); → {"result": the result line's object without the check,
    "numbers": the compared numbers, "error": a message or None, ...}."""
    from stereobench import faults

    if control in faults.FAULTS:
        with faults.planted(control):
            return run_cell(cell, seed, seconds, traced, device, t_process)

    from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
    from desktop2stereo_tpu_torch.pipeline.multi import BatchedStreamEngine

    cfg, mix = cell.config, cell.mix
    dtype = DTYPES[cfg["dtype"]]
    fam = manifest.family(cfg, cell.root)
    h, w = mix["frame"][:2]
    out_hw = (h, w)  # the output height is the capture's
    batch = mix["feeds"] if mix["engine"] == "batched" else 1  # frames a program call
    if device.type == "cuda":
        from desktop2stereo_tpu_torch.ops.kernels.build import build_all

        build_all()
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)

    with torch.device("meta"):
        ref_shapes = fam.build(cfg)
    state = weights.draw(ref_shapes, cfg["init"], traffic.derive_seed(seed, 2), device, dtype)
    program, model, root = build_program(cell, state, device, dtype, control)
    state = {k: v.cpu() for k, v in state.items()}  # the reference's, later
    rings = traffic.feed_rings(mix, seed)
    program.warmup(tuple(mix["frame"]))

    sample = Reservoir(mix["check_frames"], traffic.derive_seed(seed, 3))
    rec = record.Recorder(rings, sample, batched=mix["engine"] == "batched",
                          advance=fam.advance if getattr(fam, "STATEFUL", False) else None)
    tap = record.StageTap(model, root, cfg["check_encoders"])
    timed = record.TimedProgram(program, rec, tap)
    sinks = [record.BenchSink(f, rec, (h, w, 3)) for f in range(mix["feeds"])]
    sources = [traffic.RingSource(r) for r in rings]
    if mix["engine"] == "batched":
        engine = BatchedStreamEngine(sources, timed, sinks, target_fps=mix["capture_hz"])
    else:
        engine = FrameEngine(sources[0], timed, sinks[0], target_fps=mix["capture_hz"])
    record.install(engine, rec)
    tracer = record.SliceTrace() if traced else None
    engine.trace = tracer

    engine.start()
    w0 = time.perf_counter() + mix["lead_in_s"]
    w1 = w0 + seconds
    rec.window = (w0, w1)
    _sleep_until(w0)
    setup_s = w0 - t_process
    if tracer is not None:
        _sleep_until(w1 - mix["trace_slice_s"])
        tracer.want_start.set()
    _sleep_until(w1)
    if tracer is not None:
        tracer.want_stop.set()
    attempted = _await_window(engine, rec, w0, w1, tracer)
    error = _stop(engine)
    superseded = _superseded(engine)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    steps, deliveries = list(rec.steps), list(rec.deliveries)
    delivered = {(d.feed, d.t0) for d in deliveries}
    failed = sum(1 for key in attempted if key not in delivered) + len(rec.malformed)
    traced_slice = None
    if tracer is not None and tracer.prof is not None:
        traced_slice = _read_trace(tracer, steps)
    profiled_from = None if tracer is None else tracer.t_start
    tap.remove()
    rec.release()
    del engine, timed, program, model, root, tap, sinks, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    flops, attn = model_counts(fam, cfg, out_hw, batch)
    view = RunView(cell, seconds, (w0, w1), setup_s, steps, deliveries, profiled_from,
                   traced_slice, flops, attn, (batch, h, w // 2),
                   torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    metrics = manifest.read_metrics(cell.per_layer if traced else cell.end_to_end, view,
                                     cell.root)

    t_check = time.perf_counter()
    numbers, check_error = None, None
    if error is None and sample.items:
        try:
            numbers = check.reference_numbers(fam, cfg, cfg["display"], state, rings, steps,
                                              sample.items, out_hw, device)
        except RuntimeError as e:  # a sampled frame the check cannot place: not correct
            check_error = str(e)
    result = {"attempted": len(attempted), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": view.device_name, "count": 1,
                         "memory_peak_bytes": int(memory_peak)}}
    if traced_slice is not None:
        result["device"]["busy_s"] = traced_slice.busy_s
        result["device"]["window_s"] = traced_slice.seconds
        result["breakdown"] = {"device_ops": traced_slice.top_ops(),
                               "idle_gaps": traced_slice.idle_gaps()}
    return {"result": result, "numbers": numbers, "error": error, "check_error": check_error,
            "malformed": rec.malformed,
            "superseded": superseded, "sampled": len(sample.items),
            "delivered": len(deliveries), "steps": step_summary(steps, w0, w1),
            "check_s": time.perf_counter() - t_check}


def step_summary(steps, w0: float, w1: float) -> dict:
    """The window's program calls on the host clock, for the run's log."""
    ws = [st for st in steps if w0 <= st.t_dispatch < w1]
    if len(ws) < 2:
        return {"calls": len(ws)}
    gaps = sorted(b.t_dispatch - a.t_dispatch for a, b in zip(ws, ws[1:]))
    return {"calls": len(ws), "interval_ms_median": gaps[len(gaps) // 2] * 1e3,
            "interval_ms_max": gaps[-1] * 1e3,
            "staging_ms_mean": sum(st.upload_s for st in ws) / len(ws) * 1e3,
            "dispatch_ms_mean": sum(st.dispatch_s for st in ws) / len(ws) * 1e3}


def _await_window(engine, rec, w0: float, w1: float, tracer) -> List[Tuple[int, float]]:
    """Wait until every frame dispatched in the window has been delivered or
    dropped (at most GRACE_S) and a trace has stopped; → those frames."""
    deadline = time.perf_counter() + GRACE_S
    while True:
        attempted = [(r, t0) for st in list(rec.steps) if w0 <= st.t_dispatch < w1
                     for r, ((_, _, t0), fresh) in enumerate(zip(st.rows, st.fresh)) if fresh]
        seen = {(d.feed, d.t0) for d in list(rec.deliveries)} | set(rec.out_dropped)
        settled = all(key in seen for key in attempted)
        traced = tracer is None or tracer.done.is_set()
        if (settled and traced) or time.perf_counter() > deadline or engine.shutdown.is_set():
            return attempted
        time.sleep(0.02)


def _stop(engine) -> Optional[str]:
    engine.shutdown.set()
    for t in engine._threads:
        t.join(timeout=30.0)
    alive = [t.name for t in engine._threads if t.is_alive()]
    if engine._error is not None:
        return f"{type(engine._error).__name__}: {engine._error}"
    if alive:
        return f"engine threads still running after 30 s: {alive}"
    return None


def _superseded(engine) -> int:
    if hasattr(engine, "streams"):
        return sum(st.raw.dropped for st in engine.streams)
    return engine.raw_box.dropped


def _read_trace(tracer, steps) -> TraceSlice:
    """The traced slice, from the profiler's Chrome trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        tracer.prof.export_chrome_trace(path)
        events = load_trace(path)
    times = [st.t_dispatch for st in steps if tracer.t_start <= st.t_dispatch <= tracer.t_stop]
    return TraceSlice(events, times)
