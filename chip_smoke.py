#!/usr/bin/env python3
"""Drive the torch port's frame paths once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Model: Depth-Anything-V2-Large (DINOv2 ViT-L/14, seeded random weights) at
depth resolution 518 on a 4K BGRA capture, through `build_bound` →
`ProgramCache` → `FrameEngine` and the five hand-written CUDA kernels of
`desktop2stereo_tpu_torch`: attention (K2) on all 24 encoder layers, the
both-eyes DIBR pass (K1: the finished Half-SBS frame, or both f32 eyes for
the generic tail), the fast compositor's warp (K3), the single-eye DIBR
(K5) behind `ops.stereo.dibr_render`, and the fused int8 dense (K4) on the
four products of every encoder layer of the int8 model (`quant="int8"`).
The streaming family runs beside it: Video-Depth-Anything-Large (the same
ViT-L encoder, a temporal DPT head carrying a 31-frame window) at 518 on
the same 4K capture, and a real-shape Video-Depth-Anything-Small checkpoint
that the script writes itself goes through the loader and the CLI.  Then
the Depth-Anything-3 family at depth resolution 504 (a 280x504 input, 721
tokens): DA3-LARGE (ViT-L with QK-norm, 2D RoPE and cross-view layers from
layer 8, the DualDPT head), DA3MONO-LARGE (DPT head, sky post), int8
DA3-LARGE and DA3NESTED-GIANT-LARGE (ViT-G with SwiGLU, 40 layers, beside a
ViT-L metric branch), through the same entry points.

Phases, each of which raises on failure (non-zero exit, no result line):

1. device: CUDA present; the card's name and power limit from nvidia-smi;
   which of cv2, PIL and PyYAML the host has;
2. build: nvcc builds the five kernel sources, all at once;
3. kernel parity on the card against the plain PyTorch versions;
4. kernel times beside the plain versions, one PyTorch library call where
   one computes the same function, and the bound (bytes over the memory
   rate, operations over the peak): each callable device-only (10 calls
   captured into a CUDA graph, its replays timed with CUDA events) and eager
   (CUDA events around 10 calls, the host's cost included), median of
   interleaved runs;
5. flagship path: Half-SBS (fused tail), FRAMES 4K frames through
   FrameEngine; launch counts (24 attention + one K1 per frame);
6. reference: one small frame through the flagship program on the card
   (bf16) and on the CPU in f32 (plain versions), compared;
7. generic tail, high quality: Full-SBS, FRAMES frames; K1 eyes once a frame;
8. generic tail, fast quality: Half-SBS, FRAMES frames; K3 twice a frame;
9. mode cycling: all nine display modes twice, switched live after every
   delivered frame; each output shape and K1 once a frame (none in Depth);
10. `dibr_render` at 4K, both eyes: K5 twice;
11. reference for the generic tail (Full-SBS high, Half-SBS fast);
12. int8 against bf16: both models from one seed on one model input, raw
    output correlation and max relative error;
13. int8 flagship path: Half-SBS (fused tail), FRAMES 4K frames; launches
    24 attention + 96 K4 (4 per layer) + one K1 per frame;
14. int8 reference: one small frame through the int8 program on the card
    (bf16) and on the CPU in f32 (plain versions), compared;
15. traced frames: one flagship and one int8 4K frame as FrameEngine runs
    them (`_dispatch`: the upload through the pinned staging ring, the
    program, the copies back into pinned memory; `_finish`: the wait on the
    `done` event), and beside them one flagship frame through the harness's
    pageable path (a numpy frame into ProgramCache, `.cpu()` downloads),
    under torch.profiler with CUDA activity: device ms by kernel and by group
    (K1-K5, GEMM, convolution, elementwise, copies, other), the device's busy
    ms and its idle share of the frame;
16. the port's CLI on the card, `desktop2stereo_tpu_torch.cli.run` in this
    process: (a) a settings file written by the port's `save_settings`
    (DA-V2-Large, depth resolution 518, processing resolution 2160,
    Half-SBS, Set FPS 1000), a 4K synthetic source, the null sink, once
    with `--frames FRAMES` and once for CLI_SECONDS (`--duration`): exit 0,
    the sink's frames and shape, exactly 24 K2 and one K1 launches per frame
    in the warm-up and in the run; frames/s from the timed run; (b)
    letterboxed 4K BGRA frames (a 2.39:1 picture between 16:9 bars) written
    into the port's ShmFrameRing, `--source shm --crop auto`: the crop rect
    found on the card equals the plain CPU path's on the same frame, and the
    output has the cropped size;
17. VDA flagship: Video-Depth-Anything-Large at 518, Half-SBS (fused tail),
    FRAMES 4K frames through FrameEngine: launches 24 attention + one K1
    per frame and no other kernel, the eight caches' shapes after the run,
    stage ms (pre / model / tail) and frames/s, the four temporal modules'
    ms (CUDA events around each), peak device memory, and one traced frame
    as in phase 15, the temporal modules' kernels totalled inside their
    `record_function` ranges where the trace holds GPU-side ranges;
18. VDA reference: three small frames streamed (first, step, step) through
    the VDA program on the card (bf16) and on the CPU (f32, plain
    versions), each held to phase 6's thresholds;
19. int8 VDA: INT8_VDA_FRAMES 4K frames, launches 24 attention + 96 K4 +
    one K1 per frame;
20. checkpoint: a real-shape Video-Depth-Anything-Small checkpoint in the
    original naming (seeded, F16) written by the port's own writer as one
    file and as three shards with an index: `build_bound(...,
    checkpoint=path)` on the card holds exactly the CPU load's tensors,
    and `cli.run` with `--model Video-Depth-Anything-Small --checkpoint
    <index>` runs FRAMES 4K frames into the null sink, exit 0, 12 K2 and
    one K1 launches per frame;
21-26. the DA3 family (`da3_phases`), each path with exact launches; phase
    23 holds DA3-LARGE and DA3MONO-LARGE card bf16 against CPU f32 on a
    small frame, and DA3MONO-LARGE's raw depth (over the non-sky pixels)
    and sky mask as well, since the sky fill covers most of its frame on
    random weights;
27. remote topology, Half-SBS: `cli.run --source tcp:0 --sink xr --port 0
    --xr-no-input` on the phase-16 settings file for CLI_SECONDS, fed by a
    capture agent in a thread (the port's TcpFrameSender connection
    streaming seeded 4K BGRA frames over loopback, each packed beforehand:
    zlib-compressed noisy synthetic frames, the worst case for zlib, then
    zlib-compressed desktop-like frames, then the synthetic ones raw) and
    polled by the port's FrameNetClient in a process of its own: exit 0; 24
    K2 and one K1 a frame; the client's frames [2160, 3840, 3] u8 with depth
    [294, 518] f32 in [0, 1], each (rgb, depth) pair one the engine pushed
    into the sink (CRC-32 of the rgb and of the zu16 depth on both sides);
    the source's received / delivered / dropped add up and every delivered
    frame is one the agent sent (CRC-32 taken at the source, before the
    program); ingest fps, engine and client frames/s, bytes a frame, the
    wire ratio and the host's zlib decode ms of each frame set;
28. the same with `--display-mode Mono`, raw: the generic tail, one K1
    (eyes mode: both eyes in one pass, the left one kept) a frame;
29. `--sink rtmp --out rtmp://127.0.0.1/live/d2s` with a fake ffmpeg first on
    PATH: its argv equals the run's sink's `ffmpeg_argv` (held against the
    JAX sink's by the CPU tests) and its stdin took exactly the pushed
    Half-SBS frames' bytes;
30. the web control panel (`service.control.serve(port=0)` in a thread):
    POST /start spawns the port's CLI on the card (synthetic source, null
    sink), /status and /logs are polled until its stats line shows frames,
    POST /stop ends it with exit 0 within the grace period.

Every phase that drives a path sets the kernels' launch counts to 0 just
before it and reads them just after; launches recorded into a CUDA graph
(phase 4) are not counted.

The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.  A JSON report with every number also
goes to chiprun_out/chip_smoke.json, and the traces to
chiprun_out/trace_flagship.json, trace_int8.json,
trace_flagship_pageable.json, trace_vda.json, trace_da3.json and
trace_da3_full_outputs.json.  Each kernels entry's `launches_by_path` holds
each path's count from its own run (the flagship's, DA3-LARGE's and the
remote Half-SBS run's; K1 eyes: generic high and remote Mono; int8: both
int8 paths), and `launches` their sum.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP_MODEL = "Depth-Anything-V2-Large"
FRAME_SHAPE = (2160, 3840, 4)        # 4K BGRA capture, output height 2160
EYE = (FRAME_SHAPE[0], FRAME_SHAPE[1] // 2)
FULL = FRAME_SHAPE[:2]               # the generic tail's eyes: full width
ATTN_SHAPE = (1, 778, 16, 64)        # ViT-L/14 at 294x518: 21*37 + 1 tokens
FRAMES = 30
TIMED_RUNS = 25
SEED = 0
IPD, STRENGTH = 0.064, 2.0

# K1 / K5 (u8 after quantisation): at most 1 LSB off, on at most 0.1% of values
# (one value where a frame holds fewer than 1000)
DIBR_MAX_LSB = 1
DIBR_MAX_SHARE = 1e-3
# the DIBR kernels' edge shapes: widths below one 4-pixel group, one more than
# a 512-pixel segment, 8K full width; heights 1-4 (the ±2-row taps clamp)
DIBR_EDGES = ((1, 1), (2, 2), (3, 3), (4, 513), (3, 7680))
# K2 (bf16 in/out, f32 accumulation) vs the f32 plain version on unit-normal
# inputs: bf16 output rounding (2^-9 relative) plus bf16 probabilities
ATTN_MAX_ABS = 2e-2
# K3 (f32 on 0..255 values, the same px on both sides): lerp rounding only
WARP_MAX_ABS = 1e-3
# K4: the kernel rounds at the plain version's points, so none; a mismatch
# is a rounding point to find
QUANT_MAX_ABS = 0.0
# int8 encoder against the bf16 one (same seed, same model input): JAX on
# the CPU gives correlation 0.991 for this model at 126x224
INT8_MIN_CORR = 0.98
# ViT-L's four encoder products at M = 778 tokens: (name, K, F)
VIT_L_DENSE = (("qkv", 1024, 3072), ("proj", 1024, 1024), ("fc1", 1024, 4096),
               ("fc2", 4096, 1024))
# Whole path, card bf16 vs CPU f32 on one small frame.  bf16 drift through
# 24 layers and the percentile normalisation moves depth by a few hundredths
# and turns into warp shifts at depth edges, so the SBS bound is on the mean
# and on the share of pixels far off, not on the maximum.
REF_DEPTH_MEAN_ABS = 0.03
REF_SBS_MEAN_LSB = 3.0
REF_SBS_SHARE_OVER_32 = 0.03

# The card's peaks for the bound: HBM bytes/s and dense operations/s (bf16
# tensor cores; f32 outside them; int8 tensor cores), NVIDIA's data sheets.
# The SXM part unless the name says otherwise.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
         "H100 NVL": (3.9e12, 835e12, 60e12, 1670e12),
         "H100": (3.35e12, 989e12, 67e12, 1979e12)}
# f32 operations per output pixel of the elementwise kernels, counted from
# their sources with every sweep tap taken (the most the data can need):
# K3 lerp per channel 4 + floor/frac/clamps 2; K5 24 taps x 12 + 2 vertical
# taps x 6 + warp 14 + blend 9 + centre 10; K1 the shared taps once, warp
# and blend per eye, the shaping and falloff once.  K1 and K5 stop their
# sweeps early and take fewer; their bytes bound them either way
OPS_PER_PX = {"warp3": 14, "dibr_fill": 330, "dibr_pair": 360}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def host_packages():
    """Version (or "absent") of what some sources and sinks import when they
    are made: cv2 (mjpeg, viewer, video, window), PIL (png, image), and
    PyYAML, which the port does not use."""
    import importlib

    out = {}
    for name in ("cv2", "PIL", "yaml"):
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "present")
        except ImportError:
            out[name] = "absent"
    return out


def peaks(name: str):
    return next((v for k, v in PEAKS.items() if k in name), PEAKS["H100"])


def bound_ms(name: str, nbytes: float, ops: float, unit: str):
    """(least ms the card could take, "bytes" or "operations"); `unit` is
    the peak the operations run at: "bf16", "f32" or "int8"."""
    bw, bf16, f32, int8 = peaks(name)
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / {"bf16": bf16, "f32": f32, "int8": int8}[unit] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def config(programs, mode="Half-SBS", quality="high", model=FLAGSHIP_MODEL, res=518):
    """bench.py's flagship settings (Settings defaults otherwise), with the
    model-resolution depth a null sink takes; `res` the depth resolution."""
    return programs.ProgramConfig(
        model_name=model, depth_resolution=res, output_height=2160,
        display_mode=mode, ipd=IPD, depth_strength=STRENGTH, convergence=0.0,
        foreground_scale=0.0, aa_strength=2.0, ema_alpha=0.9,
        temporal_smooth=True, quality=quality, emit_depth="model")


def synthetic_frames(np, count: int, h: int, w: int, seed: int):
    """Seeded BGRA frames: a moving smooth scene plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(count):
        base = 128 + 90 * np.sin((xx + 40 * t) / 97.0) * np.cos(yy / 71.0)
        rgb = base[..., None] + np.array([0.0, 25.0, -25.0], np.float32)
        rgb = rgb + rng.normal(0, 10, (h, w, 3)).astype(np.float32)
        bgra = np.empty((h, w, 4), np.uint8)
        bgra[..., :3] = np.clip(rgb[..., ::-1], 0, 255)
        bgra[..., 3] = 255
        frames.append(bgra)
    return frames


def time_calls(torch, fns, runs: int = TIMED_RUNS, reps: int = 10, warm: int = 3,
               graph: bool = False):
    """Median ms per call of each callable in `fns` (name → fn), `runs`
    samples each, the callables in turns whose order flips every sample.
    Eager: CUDA events around `reps` back-to-back calls, so where a call's
    host work (Python, allocation, launch) outlasts its device work the
    figure holds the host's cost.  graph=True: the `reps` calls are captured
    once into a CUDA graph (after warm-up on a side stream) and the events
    bracket a replay, so the figure is device time only."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            for fn in fns.values():
                fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    runners = {}
    for name, fn in fns.items():
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
            g.replay()
            runners[name] = g.replay
        else:
            runners[name] = lambda fn=fn: [fn() for _ in range(reps)]
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    items = list(runners.items())
    for i in range(runs):
        for name, run in (items if i % 2 == 0 else items[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: statistics.median(v) for name, v in times.items()}


def time_both(torch, fns):
    """Graph-timed (device-only) ms per call of each callable, with the
    eager (host-inclusive) figures under "eager"."""
    graphed = time_calls(torch, fns, graph=True)
    torch.cuda.empty_cache()
    return dict(graphed, eager=time_calls(torch, fns))


# Kernel groups of a traced frame: the port's kernels by their function
# names, then library kernels by name; memcpy and memset activity is "copies"
TRACE_GROUPS = (
    ("K1 dibr_pair", r"\bdibr_pair_kernel\b"),
    ("K2 attention", r"\battention_fwd_kernel\b"),
    ("K3 warp", r"\bwarp_kernel\b"),
    ("K4 quant_matmul", r"\b(quantize_rows_kernel|quant_gemm_kernel)\b"),
    ("K5 dibr_fill", r"\bdibr_fill_kernel\b"),
    ("convolution", r"conv|fprop|dgrad|wgrad|cudnn|implicit"),
    ("gemm", r"gemm|nvjet|xmma|cutlass|cublas|gemv"),
    ("elementwise", r"elementwise|vectorized|unrolled|catarray|copy_kernel|fill"),
)


def summarize_trace(events, spans=()):
    """Device ms by kernel name and by group, busy ms and idle share of the
    span from the host's "frame" range to the end of the last device
    activity, from a chrome trace's events.  For each host range named in
    `spans` (a `record_function` label), the device ms of the kernels inside
    its GPU-side ranges (the trace's gpu_user_annotation events), or None
    where the trace holds none."""
    import re

    frame = next(e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == "frame")
    start = float(frame["ts"])
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e and float(e["ts"]) >= start]
    if not dev:
        raise AssertionError("the trace holds no device activity: no kernel ran on the card")
    end = max([start + float(frame["dur"])] + [float(e["ts"]) + float(e["dur"]) for e in dev])
    busy, reach = 0.0, start
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        a, b = max(float(e["ts"]), reach), float(e["ts"]) + float(e["dur"])
        if b > a:
            busy += b - a
            reach = b
    groups, names = {}, {}
    for e in dev:
        name = e["name"]
        if e["cat"] != "kernel":
            group = "copies"
        else:
            group = next((g for g, pat in TRACE_GROUPS if re.search(pat, name, re.I)), "other")
        for table, key in ((groups, group), (names, name)):
            slot = table.setdefault(key, {"ms": 0.0, "calls": 0})
            slot["ms"] += float(e["dur"]) / 1e3
            slot["calls"] += 1
    top = dict(sorted(names.items(), key=lambda kv: -kv[1]["ms"])[:20])
    inside = {}
    for label in spans:
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "gpu_user_annotation" and e.get("name") == label]
        kernels = [e for e in dev if e["cat"] == "kernel"
                   and any(a <= float(e["ts"]) < b for a, b in ranges)]
        inside[label] = ({"ms": sum(float(e["dur"]) for e in kernels) / 1e3,
                          "calls": len(kernels), "ranges": len(ranges)} if ranges else None)
    return {"span_ms": (end - start) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (end - start), "groups": groups, "top_kernels": top,
            "spans": inside}


def dense_inputs(np, torch, dev, M, K, F, dtype, with_bias, seed):
    """K4's inputs: activations whose rows span four decades, an int8 weight
    [F, K] with f32 per-feature scales of a lecun-normal weight's size, and
    a bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)) * 10.0 ** rng.uniform(-2, 2, (M, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (F, K)).astype(np.int8)).to(dev)
    scale = torch.from_numpy((rng.random(F) + 1.0).astype(np.float32) / (127 * K ** 0.5)).to(dev)
    bias = (torch.from_numpy(rng.standard_normal(F).astype(np.float32) * 0.1).to(dev)
            if with_bias else None)
    return x, wq, scale, bias


def u8_diff(torch, got, want):
    """(max LSB, share of values that differ) after u8 quantisation."""
    q = lambda x: (x + 0.5).clamp(0.0, 255.0).to(torch.uint8).int()  # noqa: E731
    diff = (q(got) - q(want)).abs()
    return int(diff.max().item()), (diff > 0).float().mean().item()


def edgy_depth(np, rng, h, w):
    """Runs of random depth levels plus noise: many depth edges."""
    runs = np.repeat(rng.random((h, w // 3 + 1)), 3, axis=1)[:, :w]
    return np.clip(runs + rng.normal(0, 0.01, (h, w)), 0, 1).astype(np.float32)


def check_u8(name, lsb, share, extra="", n=None):
    ok = lsb <= DIBR_MAX_LSB and (share <= DIBR_MAX_SHARE
                                  or n is not None and n < 1000 and share * n <= 1)
    log(f"[parity] {name}: max {lsb} LSB (tol {DIBR_MAX_LSB}), differing {share:.2e} "
        f"(tol {DIBR_MAX_SHARE:.0e}){extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")


class SaturatingSource:
    """Hands the engine a new frame as soon as it has taken the previous one:
    the compute stage always has its next frame, and latest-wins drops none."""

    def __init__(self, frames, count: int) -> None:
        self.frames = frames
        self.count = count
        self.sent = 0
        self.engine = None

    def grab(self):
        if self.sent == self.count:
            return None
        if not self.engine.raw_box.wait_taken(timeout=120.0):
            raise TimeoutError("the engine took no frame for 120 s")
        frame = self.frames[self.sent % len(self.frames)]
        self.sent += 1
        return frame


class CheckingNullSink:
    """Discards frames after checking them (and the model-res depth)."""

    wants_depth = True

    def __init__(self, shape) -> None:
        self.shape = shape
        self.count = 0

    def check(self, sbs, depth, shape) -> None:
        import numpy as np

        if sbs.shape != shape or sbs.dtype != np.uint8:
            raise AssertionError(f"frame {sbs.dtype} {sbs.shape}, want uint8 {shape}")
        if depth is None or not np.isfinite(depth).all():
            raise AssertionError("depth missing or not finite")

    def push(self, sbs, depth, stats) -> None:
        self.check(sbs, depth, self.shape)
        self.count += 1


class LockstepSource:
    """Hands out the next frame only after the sink delivered the previous
    one, so a switch made in the sink applies to exactly the next frame."""

    def __init__(self, frames, count: int) -> None:
        import threading

        self.frames = frames
        self.count = count
        self.sent = 0
        self.delivered = threading.Event()
        self.delivered.set()

    def grab(self):
        if self.sent == self.count:
            return None
        if not self.delivered.wait(timeout=120.0):
            raise TimeoutError("the sink delivered no frame for 120 s")
        self.delivered.clear()
        frame = self.frames[self.sent % len(self.frames)]
        self.sent += 1
        return frame


class CyclingSink(CheckingNullSink):
    """Checks each frame against its mode's shape and the K1 launches so far,
    then requests the next display mode."""

    def __init__(self, program, source, k1, modes, shapes) -> None:
        super().__init__(None)
        self.program, self.source, self.k1 = program, source, k1
        self.modes, self.shapes = modes, shapes
        self.k1_want = 0

    def push(self, sbs, depth, stats) -> None:
        mode = self.modes[self.count % len(self.modes)]
        self.check(sbs, depth, self.shapes[mode])
        self.k1_want += mode != "Depth"
        if self.k1.launches != self.k1_want:
            raise AssertionError(f"{mode}: {self.k1.launches} K1 launches after "
                                 f"{self.count + 1} frames, want {self.k1_want}")
        self.count += 1
        self.program.cycle_display_mode()
        self.source.delivered.set()


def run_engine(FrameEngine, program, source, sink, counters, frames):
    """Counts to 0, frames through FrameEngine, counts read: (fps, counts, stats)."""
    engine = FrameEngine(source, program, sink, target_fps=0.0)
    source.engine = engine
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    stats = engine.run(duration=600.0)
    wall_s = time.perf_counter() - t0
    counts = {name: k.launches for name, k in counters.items()}
    if engine.frames != frames or sink.count + engine.out_box.dropped != frames:
        raise AssertionError(f"{engine.frames} frames run, {sink.count} delivered, "
                             f"{engine.out_box.dropped} superseded; want {frames} run")
    return frames / wall_s, counts, stats


def stage_times(torch, programs, program, frame_np, cfg, spec, dev, generic: bool):
    """Per-stage device ms at the stage seams (CUDA events, host launch gaps
    included), median of TIMED_RUNS frames after 3 warm ones.  A stateful
    model carries its state: frame 0 runs `first`, the timed frames `step`."""
    p = program.program
    state = programs.init_state(*programs.ema_shape(cfg, spec, *FRAME_SHAPE[:2]), device=dev)
    names = ("pre", "model", "post", "stereo") if generic else ("pre", "model", "tail")
    times = {n: [] for n in names + ("step",)}
    with torch.inference_mode():
        frame = torch.from_numpy(frame_np).to(dev)
        for i in range(TIMED_RUNS + 3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            rgb, model_in = p.preprocess(frame)
            ev[1].record()
            raw, carry = p.model_stage(model_in, state.model)
            ev[2].record()
            if generic:
                small = p.post_stage(raw, state.ema_depth)
                ev[3].record()
                out, _ = p.stereo_stage(rgb, small)
            else:
                out, _, small = p.post_stereo_stage(raw, state.ema_depth, rgb)
            ev[-1].record()
            ev[-1].synchronize()
            state = programs.FrameState(ema_depth=small, model=carry)
            if i >= 3:
                for j, n in enumerate(names):
                    times[n].append(ev[j].elapsed_time(ev[j + 1]))
                times["step"].append(ev[0].elapsed_time(ev[-1]))
    return {k: statistics.median(v) for k, v in times.items()}, out


def reference_check(torch, name, card_prog, cpu_prog, frame):
    sbs_c, depth_c = (t.cpu() for t in card_prog(frame))
    t0 = time.perf_counter()
    sbs_r, depth_r = cpu_prog(frame)
    cpu_s = time.perf_counter() - t0
    if not torch.isfinite(depth_c).all() or sbs_c.shape != sbs_r.shape:
        raise AssertionError(f"reference {name}: non-finite depth or shape mismatch")
    d_err = (depth_c - depth_r).abs()
    s_err = (sbs_c.int() - sbs_r.int()).abs().float()
    ref = {"depth_mean_abs": d_err.mean().item(), "depth_max_abs": d_err.max().item(),
           "sbs_mean_lsb": s_err.mean().item(), "sbs_max_lsb": s_err.max().item(),
           "sbs_share_over_32": (s_err > 32).float().mean().item(), "cpu_s": cpu_s,
           "shape": list(sbs_c.shape)}
    ok = (ref["depth_mean_abs"] <= REF_DEPTH_MEAN_ABS and ref["sbs_mean_lsb"] <= REF_SBS_MEAN_LSB
          and ref["sbs_share_over_32"] <= REF_SBS_SHARE_OVER_32)
    log(f"[reference] {name}, 216x384 frame, card bf16 vs CPU f32: depth mean "
        f"{ref['depth_mean_abs']:.4f} (tol {REF_DEPTH_MEAN_ABS}) max {ref['depth_max_abs']:.4f}; "
        f"sbs {tuple(sbs_c.shape)} mean {ref['sbs_mean_lsb']:.3f} LSB (tol {REF_SBS_MEAN_LSB}) "
        f"max {ref['sbs_max_lsb']:.0f}, >32 LSB {ref['sbs_share_over_32']:.2e} "
        f"(tol {REF_SBS_SHARE_OVER_32}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"reference {name}: the card's output disagrees with the CPU f32 run")
    return ref


class CliRun:
    """One in-process `cli.run(argv)`, keeping what it made: the source,
    program and sink from `make_components`, and the FrameEngine with the
    launch counts when it started (after the warm-up and the preload of the
    shape probe).  The counts are set to 0 just before the run."""

    def __init__(self, counters, on_parts=None) -> None:
        self.counters = counters
        self.on_parts = on_parts  # called with the parts as soon as they are made
        self.parts = None
        self.engine = None
        self.warm_counts = None

    def __call__(self, argv):
        from desktop2stereo_tpu_torch import cli
        from desktop2stereo_tpu_torch.pipeline import engine as engine_mod

        run = self
        make_components, engine_cls = cli.make_components, engine_mod.FrameEngine

        def recording_make_components(args, settings):
            run.parts = make_components(args, settings)
            if run.on_parts is not None:
                run.on_parts(run.parts)
            return run.parts

        class RecordingEngine(engine_cls):
            def start(self) -> None:
                run.engine = self
                run.warm_counts = {n: k.launches for n, k in run.counters.items()}
                self.started_at = time.perf_counter()
                super().start()

        cli.make_components, engine_mod.FrameEngine = recording_make_components, RecordingEngine
        for k in self.counters.values():
            k.launches = 0
        try:
            rc = cli.run(argv)
        finally:
            cli.make_components, engine_mod.FrameEngine = make_components, engine_cls
        self.wall_s = time.perf_counter() - self.engine.started_at
        self.counts = {n: k.launches for n, k in self.counters.items()}
        return rc

    def check_launches(self, name, layers, warm_frames):
        """24 K2 and one K1 per frame run, none of the others, in the warm-up
        (`warm_frames` frames) and in the run."""
        eng = self.engine
        run_counts = {n: self.counts[n] - self.warm_counts[n] for n in self.counts}
        want = {n: 0 for n in self.counts}
        want.update(attention=layers, dibr_pair=1)
        log(f"[cli] {name}: launches in the warm-up " + ", ".join(
            f"{n} {c} (want {want[n] * warm_frames})" for n, c in self.warm_counts.items())
            + f"; in the run of {eng.frames} frames " + ", ".join(
            f"{n} {c} (want {want[n] * eng.frames})" for n, c in run_counts.items()))
        if any(self.warm_counts[n] != want[n] * warm_frames
               or run_counts[n] != want[n] * eng.frames for n in want):
            raise AssertionError(f"cli {name}: a kernel was not launched as the path needs")
        return {"warmup": self.warm_counts, "run": run_counts}


# ProgramCache.warmup runs each stage once, then 2 whole frames
CLI_WARM_FRAMES = 3
CLI_SECONDS = 10.0


def cli_settings(out_dir):
    """The flagship settings file, written by the port's save_settings."""
    from desktop2stereo_tpu_torch.core.config import Settings, load_settings, save_settings

    path = out_dir / "cli_settings.yaml"
    if path.exists():
        path.unlink()
    # Set FPS high enough that the capture never waits
    settings = Settings(model=FLAGSHIP_MODEL, depth_resolution=518, output_resolution=2160,
                        display_mode="Half-SBS", fps=1000.0)
    save_settings(settings, path)
    if load_settings(path) != settings:
        raise AssertionError("the settings file does not read back to what was written")
    return path


def cli_flagship(np, counters, layers, card, out_dir):
    """16a. `cli.run` at full width: DA-V2-Large @518, a 4K synthetic
    source, Half-SBS, the null sink.  `--frames FRAMES` as a user would ask
    for a short run: the source outpaces the engine and latest-wins
    supersedes most of its frames, so the frames/s comes from a second run
    of CLI_SECONDS (`--duration`, an endless source)."""
    base = ["--settings", str(cli_settings(out_dir)), "--source", "synthetic",
            "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null",
            "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"]
    want_shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    out = {}
    for name, extra in (("frames", ["--frames", str(FRAMES)]),
                        ("timed", ["--duration", str(CLI_SECONDS)])):
        run = CliRun(counters)
        rc = run(base + extra)
        _, program, sink, _ = run.parts
        eng = run.engine
        # a run the CLI ends (frame count, duration) may stop the sink before
        # it takes the last frame; every other frame is delivered or superseded
        if (rc != 0 or sink.frames < 1 or sink.last_shape != want_shape
                or not eng.frames - 1 <= sink.frames + eng.out_box.dropped <= eng.frames):
            raise AssertionError(f"cli flagship {name}: rc {rc}, {eng.frames} frames run, "
                                 f"{sink.frames} delivered of shape {sink.last_shape}, "
                                 f"want {want_shape}")
        launches = run.check_launches(f"flagship {name}", layers, CLI_WARM_FRAMES)
        final = eng.stats_final()
        fps = eng.frames / run.wall_s
        log(f"[cli] flagship {name}: python -m desktop2stereo_tpu_torch.cli --settings "
            f"(DA-V2-Large @518, Half-SBS, Set FPS 1000) --source synthetic --size "
            f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} --sink null {' '.join(extra)}: exit {rc}; "
            f"{eng.frames} frames run ({eng.dropped} superseded), {sink.frames} delivered "
            f"{sink.last_shape}; {fps:.2f} frames/s (frames run over {run.wall_s:.2f} s from "
            f"the engine's start to the CLI's return), the CLI's fps counter {final.fps:.2f} "
            f"(1% low {final.fps_1pct_low:.2f}); {card}")
        out[name] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames,
                         dropped=eng.dropped, fps=fps, fps_counter=final.fps,
                         fps_1pct_low=final.fps_1pct_low, wall_s=run.wall_s,
                         launches=launches)
    return out


def letterboxed_frame(np, seed):
    """A 4K BGRA frame holding a 2.39:1 picture between black 16:9 bars."""
    h, w = FRAME_SHAPE[:2]
    pic_h = int(round(w / 2.39))
    top = (h - pic_h) // 2
    frame = np.zeros((h, w, 4), np.uint8)
    frame[..., 3] = 255
    frame[top:top + pic_h] = synthetic_frames(np, 1, pic_h, w, seed)[0]
    return frame


def cli_crop(np, torch, counters, layers, card, out_dir):
    """16b. Letterboxed 4K frames through the port's shm ring into `cli.run`
    with `--crop auto`: the crop found on the card equals the plain CPU
    path's on the same frame, and the output has the cropped size."""
    import os
    import threading

    from desktop2stereo_tpu_torch.native import ShmFrameRing
    from desktop2stereo_tpu_torch.ops.normalize import process_frame_size
    from desktop2stereo_tpu_torch.pipeline.crop import BGR, apply_crop, crop_from_stats, crop_stats

    frame = letterboxed_frame(np, SEED + 2)
    ring_bytes = 3 * frame.nbytes
    vfs = os.statvfs("/dev/shm")
    if vfs.f_bavail * vfs.f_frsize < ring_bytes + (1 << 20):
        raise AssertionError(f"/dev/shm holds {vfs.f_bavail * vfs.f_frsize} free bytes; the "
                             f"ring of three 4K BGRA slots needs {ring_bytes}")
    name = f"/d2s_smoke_{os.getpid()}"
    ring = ShmFrameRing(name, max_bytes=frame.nbytes, slots=3)
    stop = threading.Event()

    def produce():  # a capture agent writing the same picture, ~200 frames/s
        while not stop.is_set():
            ring.write(frame)
            time.sleep(0.005)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    run = CliRun(counters)
    try:
        rc = run(["--settings", str(cli_settings(out_dir)), "--source", "shm", "--input", name,
                  "--crop", "auto", "--sink", "null", "--frames", str(FRAMES),
                  "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    finally:
        stop.set()
        producer.join()
        ring.close()
    _, program, sink, _ = run.parts
    eng = run.engine
    h, w = FRAME_SHAPE[:2]
    card_stats = crop_stats(torch.from_numpy(frame).cuda(), BGR).cpu().numpy()
    cpu_stats = crop_stats(torch.from_numpy(frame), BGR).numpy()
    card_rect = program.controllers[0].crop
    cpu_rect = crop_from_stats(cpu_stats, w, h)
    ch, cw = apply_crop(torch.empty(h, w), cpu_rect).shape
    want_shape = (*process_frame_size(ch, cw, 2160), 3)
    ok = (rc == 0 and card_rect == cpu_rect and cpu_rect[3] < 1.0 and sink.frames >= 1
          and sink.last_shape == want_shape)
    log(f"[cli] crop: {FRAMES} letterboxed {h}x{w} BGRA frames (2.39:1 picture) through the "
        f"port's ShmFrameRing, --crop auto: exit {rc}; crop stats card {card_stats.tolist()}, "
        f"CPU {cpu_stats.tolist()}; rect on the card {card_rect}, plain CPU path {cpu_rect}; "
        f"{eng.frames} frames run, {sink.frames} delivered {sink.last_shape} (want "
        f"{want_shape}) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli crop: the card's crop or the output size is off")
    launches = run.check_launches("crop", layers, CLI_WARM_FRAMES)
    return dict(rc=rc, card_rect=list(card_rect), cpu_rect=list(cpu_rect),
                card_stats=card_stats.tolist(), cpu_stats=cpu_stats.tolist(),
                frames_run=eng.frames, delivered=sink.frames, shape=list(sink.last_shape),
                launches=launches)


# ---- 27-30: the remote topology ---------------------------------------------

REMOTE_DISTINCT = 4      # seeded 4K frames the capture agent cycles through
RTMP_URL = "rtmp://127.0.0.1/live/d2s"
MODEL_SHAPE = (294, 518)  # DA-V2-Large's input for a 4K capture at 518
CONTROL_S = 600.0         # bound on the control panel's worker reaching its first stats line


# The XR client, in a process of its own as on the headset's workstation:
# polls the xr sink (raw rgb, zu16 depth) until the stop file exists, then
# prints what it received as one JSON line
XR_CLIENT = r"""
import json, os, sys, time, zlib
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, sys.argv[1])
from desktop2stereo_tpu_torch.xr.net import FrameNetClient, _encode_depth
client = FrameNetClient(port=int(sys.argv[2]))
pool = ThreadPoolExecutor(2)  # the rgb's CRC-32 off the poll loop (each packet is a fresh array)
seen, t0, t1 = [], None, None
try:
    while not os.path.exists(sys.argv[3]):
        p = client.poll(timeout=0.5)
        if p is None:
            continue
        t1 = time.perf_counter()
        t0 = t0 or t1
        d = p.depth
        zd = _encode_depth(d)
        seen.append([list(p.rgb.shape), str(p.rgb.dtype), p.rgb.nbytes, len(zd),
                     list(d.shape), str(d.dtype), float(d.min()), float(d.max()),
                     pool.submit(zlib.crc32, p.rgb), zlib.crc32(zd)])
except (ConnectionError, OSError):
    pass  # the sink went away at the end of the run
client.close()
pool.shutdown()
for s in seen:
    s[8] = s[8].result()
print(json.dumps({"seen": seen, "s": (t1 - t0) if seen else 0.0}))
"""


class RemoteFeed:
    """A capture agent and an XR client around one in-process `cli.run`.

    Once the CLI has made its parts, a thread connects the port's
    TcpFrameSender to the tcp source's bound port and streams REMOTE_DISTINCT
    seeded 4K BGRA frames in a cycle, each packed once (`_pack`: raw, or
    zlib-compressed as `--compress zlib` does) and written as fast as
    loopback takes it, until the run ends; the agent's compression is left
    out of the rate (a desktop does it on its own cores).  The source's
    `grab` is wrapped to hand each delivered frame to a thread that takes
    its CRC-32 (the frames are fresh arrays the program only reads) for the
    check after the run.  With an xr sink, XR_CLIENT runs in a subprocess,
    and the sink's `push` is wrapped to take the CRC-32 of each pushed SBS
    frame and of its depth as the wire carries it (`_encode_depth`) before
    the sink has it, so each frame the client received can be matched to a
    pushed one."""

    def __init__(self, packets, client: bool, out_dir):
        import queue
        import threading

        self.packets, self.client = packets, client
        self.stop = threading.Event()
        self.stop_file = out_dir / "xr_client.stop"
        self.crcs, self.ingest_fps, self.client_out = [], [], None
        self.pushed, self.push_crc_s = set(), 0.0
        self.sent, self.sent_s = 0, 0.0
        self.source = self.sink = self.proc = None
        self.threads = []
        self._delivered = queue.SimpleQueue()

    def on_parts(self, parts):
        import threading

        self.source, _, self.sink, _ = parts
        grab = self.source.grab

        def kept_grab():
            frame = grab()
            if frame is not None:
                self._delivered.put(frame)
                self.ingest_fps.append(self.source.stats()["ingest_fps"])
            return frame

        self.source.grab = kept_grab
        if self.client:
            self._hash_pushes()
        self.threads = [threading.Thread(target=t, daemon=True)
                        for t in (self._hasher, self._agent)]
        for t in self.threads:
            t.start()
        if self.client:
            if self.stop_file.exists():
                self.stop_file.unlink()
            self.proc = subprocess.Popen(
                [sys.executable, "-c", XR_CLIENT, str(ROOT), str(self.sink.port),
                 str(self.stop_file)], stdout=subprocess.PIPE, text=True)

    def _hash_pushes(self):
        import zlib

        import numpy as np

        from desktop2stereo_tpu_torch.xr.net import _encode_depth

        push = self.sink.push

        def hashed_push(sbs, depth, stats):
            t0 = time.perf_counter()
            self.pushed.add((zlib.crc32(np.ascontiguousarray(sbs)),
                             zlib.crc32(_encode_depth(depth))))
            self.push_crc_s += time.perf_counter() - t0
            push(sbs, depth, stats)

        self.sink.push = hashed_push

    def _hasher(self):
        import zlib

        while True:
            frame = self._delivered.get()
            if frame is None:
                return
            self.crcs.append(zlib.crc32(frame))  # releases the GIL on a frame

    def _agent(self):
        from desktop2stereo_tpu_torch.sources.net import TcpFrameSender

        snd = TcpFrameSender("127.0.0.1", self.source.port)
        t0 = time.perf_counter()
        try:
            while not self.stop.is_set():
                snd.sock.sendall(self.packets[self.sent % len(self.packets)])
                self.sent += 1
                self.sent_s = time.perf_counter() - t0
        except OSError:
            pass  # the source closed at the end of the run
        finally:
            snd.close()

    def finish(self):
        self.stop.set()
        self._delivered.put(None)
        if self.proc is not None:
            self.stop_file.touch()
            out, _ = self.proc.communicate(timeout=60)
            if self.proc.returncode != 0:
                raise AssertionError(f"the XR client exited {self.proc.returncode}")
            self.client_out = json.loads(out.strip().splitlines()[-1])
        for t in self.threads:
            t.join(60)
            if t.is_alive():
                raise AssertionError(f"remote feed: thread {t.name} did not end")


def remote_packets(frames, compress: str):
    """The agent's frames, each packed once as TcpFrameSender sends it (in
    parallel: zlib releases the GIL), their CRC-32s, and the ms it took."""
    import socket
    import zlib

    from desktop2stereo_tpu_torch.sources.net import TcpFrameSender

    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    snd = TcpFrameSender("127.0.0.1", lst.getsockname()[1], compress=compress)
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(frames)) as pool:
            packets = list(pool.map(snd._pack, frames))
        pack_ms = (time.perf_counter() - t0) * 1e3
    finally:
        snd.close()
        lst.close()
    return packets, {zlib.crc32(f) for f in frames}, pack_ms


def zlib_decode_ms(packet) -> float:
    """The host's ms to inflate one zlib 4K frame at the source (median of 5)."""
    from desktop2stereo_tpu_torch.sources.net import _FRAME_HDR, _decode_payload

    _, w, h, c, flags, _ = _FRAME_HDR.unpack(packet[:_FRAME_HDR.size])
    payload = packet[_FRAME_HDR.size:]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        _decode_payload(payload, w, h, c, flags)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def remote_run(counters, layers, card, out_dir, name, packets, crcs, sink_argv,
               mode="Half-SBS", client=True, on_parts=None):
    """One `cli.run --source tcp:0` on the flagship settings file for
    CLI_SECONDS (`--duration`: a steady stream, as phase 16a times the
    CLI), fed by a RemoteFeed; checks the exit code, the launches (24 K2 and
    one K1 a frame), the source's stats, and that every delivered frame is
    one the agent sent (by CRC-32).  Returns (measurements, CliRun,
    RemoteFeed)."""
    feed = RemoteFeed(packets, client, out_dir)

    def parts(p):
        feed.on_parts(p)
        if on_parts is not None:
            on_parts(p)

    run = CliRun(counters, on_parts=parts)
    try:
        rc = run(["--settings", str(cli_settings(out_dir)), "--source", "tcp:0",
                  "--display-mode", mode, "--duration", str(CLI_SECONDS), *sink_argv,
                  "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    finally:
        feed.finish()
    eng = run.engine
    st = feed.source.stats()
    bad = sum(c not in crcs for c in feed.crcs)
    fps = eng.frames / run.wall_s
    readings = [v for v in feed.ingest_fps if v > 0]
    out = dict(rc=rc, frames_run=eng.frames, dropped=eng.dropped, engine_fps=fps,
               sent=feed.sent, received=st["frames_received"],
               delivered=st["frames_delivered"], net_dropped=st["frames_dropped"],
               decode_errors=st["decode_errors"], not_sent=bad,
               ingest_fps=statistics.median(readings) if readings else 0.0,
               received_per_s=st["frames_received"] / feed.sent_s if feed.sent_s else 0.0,
               wall_s=run.wall_s)
    ok = (rc == 0 and st["decode_errors"] == 0 and bad == 0
          and st["frames_delivered"] == len(feed.crcs)
          and st["frames_received"] == st["frames_delivered"] + st["frames_dropped"]
          and st["frames_delivered"] <= st["frames_received"] <= feed.sent
          and 1 <= eng.frames <= st["frames_delivered"])
    log(f"[remote] {name}: cli --source tcp:0 --display-mode {mode} {' '.join(sink_argv)} "
        f"--duration {CLI_SECONDS}: exit {rc}; the agent sent {feed.sent} 4K BGRA frames in "
        f"{feed.sent_s:.2f} s; the source received {st['frames_received']}, delivered "
        f"{st['frames_delivered']}, dropped {st['frames_dropped']}, decode errors "
        f"{st['decode_errors']}; {bad} delivered frames not among the sent ones (CRC-32); "
        f"ingest fps {out['ingest_fps']:.2f} (the source's stats, median of its readings at "
        f"each delivery), {out['received_per_s']:.2f} frames received a second of sending; "
        f"engine {eng.frames} frames run ({eng.dropped} superseded), {fps:.2f} frames/s over "
        f"{run.wall_s:.2f} s; {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError(f"remote {name}: exit code, ingest stats or frames off")
    out["launches"] = run.check_launches(f"remote {name}", layers, CLI_WARM_FRAMES)
    return out, run, feed


def remote_client_check(feed, name, want_rgb, card):
    """The XR client's frames: the frame's shape in u8, the depth at the
    model's resolution in f32 within [0, 1], and each (rgb, depth) pair, by
    CRC-32, one the engine pushed into the sink; its frames/s and bytes a
    frame."""
    seen, secs = feed.client_out["seen"], feed.client_out["s"]
    not_pushed = sum((p[8], p[9]) not in feed.pushed for p in seen)
    ok = bool(seen) and not_pushed == 0 and all(
        tuple(rgb_shape) == want_rgb and rgb_dtype == "uint8" and tuple(d_shape) == MODEL_SHAPE
        and d_dtype == "float32" and 0.0 <= d_min <= d_max <= 1.0
        for rgb_shape, rgb_dtype, _, _, d_shape, d_dtype, d_min, d_max, _, _ in seen)
    crc_ms = feed.push_crc_s * 1e3 / len(feed.pushed) if feed.pushed else 0.0
    fps = (len(seen) - 1) / secs if len(seen) > 1 and secs else 0.0
    rgb_b = statistics.median(p[2] for p in seen) if seen else 0
    dep_b = statistics.median(p[3] for p in seen) if seen else 0
    lo = min((p[6] for p in seen), default=None)
    hi = max((p[7] for p in seen), default=None)
    log(f"[remote] {name} XR client (the port's FrameNetClient in a process of its own, raw "
        f"rgb, zu16 depth): {len(seen)} frames, {fps:.2f} frames/s (first to last), rgb "
        f"{rgb_b} bytes and depth {dep_b} bytes a frame (median); the first frame "
        f"{seen[0][:2] if seen else None}, depth {seen[0][4:6] if seen else None} in "
        f"[{lo}, {hi}] (want {list(want_rgb)} uint8, depth {list(MODEL_SHAPE)} float32 in "
        f"[0, 1]); {not_pushed} of its frames not among the {len(feed.pushed)} pushed ones "
        f"(CRC-32 of the rgb and the zu16 depth; {crc_ms:.2f} ms a push on the sink thread) "
        f"{'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError(f"remote {name}: the XR client's frames are off")
    return dict(frames=len(seen), fps=fps, rgb_bytes=rgb_b, depth_bytes=dep_b,
                not_pushed=not_pushed, pushed=len(feed.pushed), push_crc_ms=crc_ms)


def desktop_frames(np, count: int, h: int, w: int, seed: int):
    """Seeded BGRA frames that look like a desktop: a flat wallpaper and
    taskbar, windows with flat title bars and borders, and lines of text
    drawn from a seeded 64-glyph font (8x14 cells), light and dark themes;
    each frame moves the windows and scrolls their text."""
    rng = np.random.default_rng(seed)
    glyphs = (rng.random((64, 14, 8)) < 0.3)
    glyphs[:, :2] = glyphs[:, 12:] = glyphs[:, :, 7] = False  # line gap and letter gap
    glyphs[0] = False  # the space
    lines, cols = 60, 200
    text = rng.integers(1, 64, (lines + count * 2, cols))
    text[rng.random(text.shape) < 0.18] = 0
    windows = [((0.08, 0.06, 0.42, 0.55), (235, 235, 235), (30, 30, 30), (190, 120, 40)),
               ((0.30, 0.38, 0.48, 0.50), (35, 30, 30), (200, 210, 210), (90, 90, 90)),
               ((0.58, 0.10, 0.38, 0.42), (250, 250, 250), (60, 60, 60), (140, 80, 200))]
    frames = []
    for t in range(count):
        bgra = np.empty((h, w, 4), np.uint8)
        bgra[...] = (120, 80, 30, 255)  # wallpaper
        bgra[h - h // 27:] = (40, 40, 40, 255)  # taskbar
        for i, ((y, x, hh, ww), bg, fg, bar) in enumerate(windows):
            y0, x0 = int(y * h) + 23 * t * (i - 1), int(x * w) + 41 * t * (1 - i)
            wh, ww = int(hh * h), int(ww * w)
            y0, x0 = min(max(y0, 0), h - wh - 1), min(max(x0, 0), w - ww - 1)
            bgra[y0:y0 + wh, x0:x0 + ww, :3] = (128, 128, 128)  # border
            bgra[y0 + 1:y0 + 31, x0 + 1:x0 + ww - 1, :3] = bar
            area = bgra[y0 + 31:y0 + wh - 1, x0 + 1:x0 + ww - 1, :3]
            area[...] = bg
            rows, cs = min(area.shape[0] // 14, lines), min(area.shape[1] // 8 - 2, cols)
            ink = glyphs[text[2 * t + i:2 * t + i + rows, :cs]]  # [rows, cs, 14, 8]
            ink = ink.transpose(0, 2, 1, 3).reshape(rows * 14, cs * 8)
            area[:rows * 14, 8:8 + cs * 8][ink] = fg
        frames.append(bgra)
    return frames


def remote_phases(np, counters, layers, card, out_dir):
    """27-29: the remote topology through `cli.run` on the flagship
    settings file (DA-V2-Large @518), fed over loopback by a capture agent:
    zlib on the noisy synthetic frames (the worst case for zlib) and on
    desktop-like ones, then raw."""
    want_rgb = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    raw_bytes = FRAME_SHAPE[0] * FRAME_SHAPE[1] * 4
    out = {}
    xr = ["--sink", "xr", "--port", "0", "--xr-no-input"]
    frames = synthetic_frames(np, REMOTE_DISTINCT, *FRAME_SHAPE[:2], seed=SEED + 27)
    desktop = desktop_frames(np, REMOTE_DISTINCT, *FRAME_SHAPE[:2], seed=SEED + 27)
    runs = (("xr_zlib", frames, "zlib"),
            ("xr_zlib_desktop", desktop, "zlib"), ("xr_raw", frames, "none"))
    for name, feed_frames, compress in runs:  # 27: Half-SBS into the xr sink
        packets, crcs, pack_ms = remote_packets(feed_frames, compress)
        res, _, feed = remote_run(counters, layers, card, out_dir, name, packets, crcs, xr)
        res["client"] = remote_client_check(feed, name, want_rgb, card)
        res["wire_bytes"] = statistics.median(len(p) for p in packets)
        res["pack_ms"] = pack_ms / len(packets)
        if compress == "zlib":
            res["zlib_decode_ms"] = zlib_decode_ms(packets[0])
            log(f"[remote] {name}: {res['wire_bytes']} wire bytes a 4K BGRA frame "
                f"({res['wire_bytes'] / raw_bytes:.4f} of raw); compress {res['pack_ms']:.1f} ms "
                f"a frame (the agent's side, {len(packets)} in parallel), decode at the source "
                f"{res['zlib_decode_ms']:.1f} ms a frame (median of 5); {card}")
        out[name] = res
        del feed

    # 28: Mono, raw: the generic tail, whose stereo stage computes both eyes
    # in one K1 pass (eyes mode) and keeps the left one
    res, _, feed = remote_run(counters, layers, card, out_dir, "xr_mono", packets, crcs, xr,
                              mode="Mono")
    res["client"] = remote_client_check(feed, "xr_mono", want_rgb, card)
    out["xr_mono"] = res
    del feed

    # 29: the rtmp sink into a fake ffmpeg first on PATH
    out["rtmp"] = rtmp_phase(counters, layers, card, out_dir, packets, crcs)
    return out


def rtmp_phase(counters, layers, card, out_dir, packets, crcs):
    """29. The rtmp sink into a fake ffmpeg first on PATH: its argv and the
    bytes on its stdin."""
    import os

    fake = out_dir / "fake_ffmpeg"
    if fake.exists():
        for f in fake.iterdir():
            f.unlink()
    fake.mkdir(exist_ok=True)
    ffmpeg = fake / "ffmpeg"
    # ignores SIGTERM (the sink terminates it right after closing its stdin)
    ffmpeg.write_text(f"#!/bin/sh\ntrap '' TERM\nprintf '%s\\n' \"$0\" \"$@\" > \"{fake}/$$.argv\"\n"
                      f"wc -c > \"{fake}/$$.tmp\" && mv \"{fake}/$$.tmp\" \"{fake}/$$.bytes\"\n")
    ffmpeg.chmod(0o755)
    pushed = {"n": 0}

    def count_pushes(parts):
        sink = pushed["sink"] = parts[2]
        push = sink.push

        def counted(*a):
            push(*a)
            pushed["n"] += 1

        sink.push = counted

    path = os.environ["PATH"]
    os.environ["PATH"] = f"{fake}{os.pathsep}{path}"
    try:
        res, _, _ = remote_run(counters, layers, card, out_dir, "rtmp", packets, crcs,
                                 ["--sink", "rtmp", "--out", RTMP_URL], client=False,
                                 on_parts=count_pushes)
    finally:
        os.environ["PATH"] = path
    deadline = time.monotonic() + 60
    while not list(fake.glob("*.bytes")) and time.monotonic() < deadline:
        time.sleep(0.05)
    argvs = sorted(fake.glob("*.argv"))
    counts = [int(f.read_text()) for f in sorted(fake.glob("*.bytes"))]
    want = pushed["sink"].ffmpeg_argv(*FRAME_SHAPE[:2])
    got = argvs[0].read_text().splitlines() if argvs else None
    frame_bytes = FRAME_SHAPE[0] * FRAME_SHAPE[1] * 3
    ok = len(argvs) == 1 and counts == [pushed["n"] * frame_bytes] and pushed["n"] >= 1 \
        and got == want
    log(f"[remote] rtmp: ffmpeg started {len(argvs)} time(s) with argv {got} (want {want}); "
        f"{counts} bytes on its stdin for {pushed['n']} pushed frames of {frame_bytes} bytes "
        f"(Half-SBS 2160x3840 rgb24) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("remote rtmp: the ffmpeg argv or the bytes on its stdin are off")
    res.update(argv=got, stdin_bytes=counts, pushed=pushed["n"])
    return res


def control_phase(card, out_dir):
    """30. The web control panel in a thread of this process: POST /start
    with the synthetic source and the null sink spawns the port's CLI on the
    card (DA-V2-Large @518); /status and /logs are polled until the worker's
    stats line shows frames; POST /stop ends it through the stop file, and
    it exits 0 within the grace period."""
    import os
    import threading
    import urllib.parse
    import urllib.request

    from desktop2stereo_tpu_torch.service import control

    work = out_dir / "control"
    work.mkdir(exist_ok=True)
    cwd, pythonpath = os.getcwd(), os.environ.get("PYTHONPATH")
    os.chdir(work)  # the panel keeps its log, stop file and settings here
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), pythonpath) if p)
    server = control.serve(port=0, settings_path=str(work / "settings.yaml"))
    manager = server.manager
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def get(path):
        return urllib.request.urlopen(url + path, timeout=60).read()

    def post(path, fields):
        urllib.request.urlopen(urllib.request.Request(
            url + path, data=urllib.parse.urlencode(fields).encode()), timeout=60).read()

    try:
        t0 = time.perf_counter()
        post("/start", {"source": "synthetic", "sink": "null", "model": FLAGSHIP_MODEL,
                        "depth_resolution": "518", "output_resolution": "1080",
                        "display_mode": "Half-SBS", "fps": "1000"})
        status = {}
        while not status.get("stats", {}).get("fps"):
            if time.perf_counter() - t0 > CONTROL_S or not manager.running:
                raise AssertionError("control: the worker showed no frames:\n"
                                     + get("/logs").decode(errors="replace")[-4000:])
            time.sleep(0.25)
            status = json.loads(get("/status"))
        first_s = time.perf_counter() - t0
        logs = get("/logs").decode(errors="replace")
        t1 = time.perf_counter()
        post("/stop", {})
        rc = manager.proc.wait(60)
        stop_s = time.perf_counter() - t1
    finally:
        if manager.running:
            manager.proc.kill()
            manager.proc.wait(60)
        server.shutdown()
        server.server_close()
        thread.join(60)
        os.chdir(cwd)
        if pythonpath is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = pythonpath
    tail = (work / "logs" / "worker.log").read_text(errors="replace")
    ok = (rc == 0 and "device: cuda" in logs and "stop.request received" in tail
          and stop_s < 8.5 and status["stats"]["fps"] > 0)
    log(f"[control] POST /start (synthetic 1080x1920, null sink, DA-V2-Large @518): the worker "
        f"(pid {status['pid']}) showed {status['stats']} in /status {first_s:.2f} s after the "
        f"POST (stats every 2 s); POST /stop: exit {rc} in {stop_s:.2f} s (grace 8 s: the stop "
        f"file, then SIGINT at 4 s) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("control: the worker did not run on the card or stop cleanly:\n"
                             + tail[-4000:])
    return dict(spawn_to_stats_s=first_s, stats=status["stats"], rc=rc, stop_s=stop_s)


VDA_MODEL = "Video-Depth-Anything-Large"
CKPT_MODEL = "Video-Depth-Anything-Small"
INT8_VDA_FRAMES = 10


def vda_cache_shapes(spec, mh: int, mw: int):
    """The eight caches' shapes at a model input of mh x mw: the patch grid
    (temporal module 0, neck[2] channels), the stride-2 half grid (module 1,
    neck[3]), the grid and twice the grid (modules 2 and 3, the fusion
    channels), two attention sites each."""
    gh, gw = mh // spec.patch_size, mw // spec.patch_size
    neck, fusion = spec.neck_channels, spec.fusion_channels
    sites = ((gh * gw, neck[2]), (((gh + 1) // 2) * ((gw + 1) // 2), neck[3]),
             (gh * gw, fusion), (4 * gh * gw, fusion))
    return [(1, p, 31, c) for p, c in sites for _ in range(2)]


def temporal_flops(pixels: int, channels: int, window: int = 32) -> float:
    """Operations of one temporal module in a streaming step (one query
    frame, K and V over the whole window): proj_in and proj_out, two
    attention blocks (q, K and V over the window, logits and P·V, to_out)
    and the GEGLU feed-forward (C → 8C, 4C → C)."""
    R, C, n = pixels, channels, window
    attn = 2 * R * C * C + 2 * 2 * R * n * C * C + 2 * 2 * R * n * C + 2 * R * C * C
    return 2 * 2 * R * C * C + 2 * attn + 2 * R * C * 8 * C + 2 * R * 4 * C * C


def vda_original_arrays(np, spec, seed: int):
    """A Video-Depth-Anything checkpoint in its original naming (pretrained.*
    and head.*) at `spec`'s widths, values drawn from a seeded normal (x0.02)
    and stored as F16, as a release would ship them."""
    hidden, layers, _, mlp = spec.dims
    neck, fusion = spec.neck_channels, spec.fusion_channels
    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, *shape):
        sd[name] = (rng.standard_normal(shape, dtype=np.float32) * 0.02).astype(np.float16)

    add("pretrained.cls_token", 1, 1, hidden)
    add("pretrained.pos_embed", 1, 37 * 37 + 1, hidden)
    add("pretrained.patch_embed.proj.weight", hidden, 3, spec.patch_size, spec.patch_size)
    for n in ("pretrained.patch_embed.proj.bias", "pretrained.norm.weight",
              "pretrained.norm.bias"):
        add(n, hidden)
    for i in range(layers):
        p = f"pretrained.blocks.{i}."
        for n in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "attn.proj.bias",
                  "ls1.gamma", "ls2.gamma", "mlp.fc2.bias"):
            add(p + n, hidden)
        add(p + "attn.qkv.weight", 3 * hidden, hidden)
        add(p + "attn.qkv.bias", 3 * hidden)
        add(p + "attn.proj.weight", hidden, hidden)
        add(p + "mlp.fc1.weight", mlp, hidden)
        add(p + "mlp.fc1.bias", mlp)
        add(p + "mlp.fc2.weight", hidden, mlp)
    for i, ch in enumerate(neck):
        add(f"head.projects.{i}.weight", ch, hidden, 1, 1)
        add(f"head.projects.{i}.bias", ch)
        add(f"head.scratch.layer{i + 1}_rn.weight", fusion, ch, 3, 3)
    for i, k in ((0, 4), (1, 2), (3, 3)):
        add(f"head.resize_layers.{i}.weight", neck[i], neck[i], k, k)
        add(f"head.resize_layers.{i}.bias", neck[i])
    for rn in (1, 2, 3, 4):
        p = f"head.scratch.refinenet{rn}."
        add(p + "out_conv.weight", fusion, fusion, 1, 1)
        add(p + "out_conv.bias", fusion)
        for unit in (1, 2):
            for conv in (1, 2):
                add(p + f"resConfUnit{unit}.conv{conv}.weight", fusion, fusion, 3, 3)
                add(p + f"resConfUnit{unit}.conv{conv}.bias", fusion)
    for m, C in enumerate((neck[2], neck[3], fusion, fusion)):
        p = f"head.motion_modules.{m}.temporal_transformer."
        for n in ("norm.weight", "norm.bias", "proj_in.bias", "proj_out.bias"):
            add(p + n, C)
        add(p + "proj_in.weight", C, C)
        add(p + "proj_out.weight", C, C)
        bp = p + "transformer_blocks.0."
        for a in range(2):
            ap = bp + f"attention_blocks.{a}."
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                add(ap + n + ".weight", C, C)
            add(ap + "to_out.0.bias", C)
            add(bp + f"norms.{a}.weight", C)
            add(bp + f"norms.{a}.bias", C)
        for n in ("ff_norm.weight", "ff_norm.bias", "ff.net.2.bias"):
            add(bp + n, C)
        add(bp + "ff.net.0.proj.weight", 8 * C, C)
        add(bp + "ff.net.0.proj.bias", 8 * C)
        add(bp + "ff.net.2.weight", C, 4 * C)
    add("head.scratch.output_conv1.weight", fusion // 2, fusion, 3, 3)
    add("head.scratch.output_conv1.bias", fusion // 2)
    add("head.scratch.output_conv2.0.weight", 32, fusion // 2, 3, 3)
    add("head.scratch.output_conv2.0.bias", 32)
    add("head.scratch.output_conv2.2.weight", 1, 32, 1, 1)
    add("head.scratch.output_conv2.2.bias", 1)
    return sd


class _Probe:
    """Within `with`: every call of `owner.attr` (a method of a class, or a
    function of a module that its callers look up there) bracketed by CUDA
    events (`records`, in call order) or inside `record_function(label)`."""

    def __init__(self, torch, owner, attr: str, label=None) -> None:
        self.torch, self.owner, self.attr, self.label = torch, owner, attr, label
        self.records = []

    def __enter__(self):
        torch, orig, probe = self.torch, getattr(self.owner, self.attr), self
        self.orig = orig

        def wrapped(*args, **kw):
            if probe.label is not None:
                with torch.profiler.record_function(probe.label):
                    return orig(*args, **kw)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = orig(*args, **kw)
            b.record()
            probe.records.append((a, b))
            return out

        setattr(self.owner, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


def vda_phases(np, torch, programs, build_bound, drive, driven, trace, paths, frames,
               policy, dev, card):
    """17-19: Video-Depth-Anything-Large at depth resolution 518 on 4K
    Half-SBS (the fused tail): FRAMES frames through FrameEngine with exact
    launches, the eight cache shapes, stage ms, the temporal modules' ms,
    peak memory and a traced frame; three small frames streamed on the card
    (bf16) and on the CPU (f32) against each other; the int8 encoder."""
    from desktop2stereo_tpu_torch.models import vda as VDA

    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vda, vda_spec = build_bound(VDA_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    out["build_s"] = time.perf_counter() - t0
    layers = len(vda.backbone.layer)
    shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    cfg = drive("vda", vda, "Half-SBS", "high", shape, {"attention": layers, "dibr_pair": 1},
                net_spec=vda_spec)
    program = driven.pop("vda")
    mh, mw = programs.ema_shape(cfg, vda_spec, *FRAME_SHAPE[:2])
    want = vda_cache_shapes(vda_spec, mh, mw)
    (key,) = program._states
    carry = program._states[key].model
    got = [tuple(c.shape) for c in carry]
    carry_mb = sum(c.numel() * c.element_size() for c in carry) / 1e6
    ok = got == want and all(c.dtype == policy.compute_dtype for c in carry)
    log(f"[vda] carry after {FRAMES} frames, key {key}: {len(carry)} caches {got} (want "
        f"{want}), {carry_mb:.1f} MB {carry[0].dtype} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("vda: the carry's caches have the wrong shapes")

    # the temporal modules' share of a steady-state frame: CUDA events around
    # each module's forward (eager, host gaps included), median of 10 frames
    with _Probe(torch, VDA.TemporalTransformer, "forward") as probe:
        per_frame = []
        for i in range(11):
            probe.records.clear()
            program(frames[i % len(frames)])
            torch.cuda.synchronize()
            if i:
                per_frame.append([a.elapsed_time(b) for a, b in probe.records])
    site_ms = [statistics.median(f[m] for f in per_frame) for m in range(4)]
    gh, gw = mh // vda_spec.patch_size, mw // vda_spec.patch_size
    pixels = (gh * gw, ((gh + 1) // 2) * ((gw + 1) // 2), gh * gw, 4 * gh * gw)
    chans = (vda_spec.neck_channels[2], vda_spec.neck_channels[3], vda_spec.fusion_channels,
             vda_spec.fusion_channels)
    flops = [temporal_flops(p, c) for p, c in zip(pixels, chans)]
    bound = bound_ms(policy.name, sum(c.numel() * c.element_size() for c in carry),
                     sum(flops), "bf16")
    out["temporal"] = dict(module_ms=site_ms, total_ms=statistics.median(map(sum, per_frame)),
                           gflop=[f / 1e9 for f in flops], bound=bound)
    log(f"[vda] temporal modules in a streamed 4K frame (CUDA events around each module, "
        f"eager, median of 10): " + ", ".join(
            f"module {m} [{p} px, C {c}] {ms:.3f} ms for {f / 1e9:.1f} GFLOP"
            for m, (p, c, ms, f) in enumerate(zip(pixels, chans, site_ms, flops)))
        + f"; total {out['temporal']['total_ms']:.3f} ms for {sum(flops) / 1e12:.3f} TFLOP, "
        f"bound {bound[0]:.3f} ms ({bound[1]}); {card}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["carry_mb"] = carry_mb
    out["cache_shapes"] = [list(g) for g in got]
    log(f"[vda] peak device memory since the model build {out['peak_mem_gb']:.2f} GB "
        f"(torch.cuda.max_memory_allocated); {card}")
    del program

    with _Probe(torch, VDA.TemporalTransformer, "forward", label="vda_temporal"):
        out["trace"] = trace("vda", vda, vda_spec, cfg, "engine",
                             {"K2 attention": layers, "K1 dibr_pair": 1}, spans=("vda_temporal",))

    # -- 18. three small frames streamed on the card and on the CPU -------
    cpu_vda, _ = build_bound(VDA_MODEL, device="cpu", dtype=torch.float32, seed=SEED)
    card_prog = programs.ProgramCache(cfg, vda, vda_spec, compute_dtype=policy.compute_dtype)
    cpu_prog = programs.ProgramCache(cfg, cpu_vda, vda_spec, compute_dtype=torch.float32)
    small = synthetic_frames(np, 3, 216, 384, SEED + 5)
    out["reference"] = [reference_check(torch, f"vda frame {i} ({'step' if i else 'first'})",
                                        card_prog, cpu_prog, f) for i, f in enumerate(small)]
    (key,) = card_prog._states
    rel = [((c.float().cpu() - r).abs().max() / r.abs().max().clamp_min(1e-6)).item()
           for c, r in zip(card_prog._states[key].model, cpu_prog._states[key].model)]
    out["reference_carry_max_rel"] = rel
    log(f"[vda] carry after 3 small frames, card bf16 against CPU f32, max abs err over max "
        f"abs per cache: " + ", ".join(f"{r:.4f}" for r in rel))
    del cpu_vda, cpu_prog, card_prog

    # -- 19. int8 VDA ----------------------------------------------------------
    t0 = time.perf_counter()
    vda_q, _ = build_bound(VDA_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED,
                           quant="int8")
    out["int8_build_s"] = time.perf_counter() - t0
    drive("vda_int8", vda_q, "Half-SBS", "high", shape,
          {"attention": layers, "quant_matmul": 4 * layers, "dibr_pair": 1},
          net_spec=vda_spec, n_frames=INT8_VDA_FRAMES)
    driven.pop("vda_int8")
    out["paths"] = {k: paths[k] for k in ("vda", "vda_int8")}
    del vda, vda_q
    torch.cuda.empty_cache()
    return out


def checkpoint_phase(np, torch, build_bound, counters, dev, card, out_dir):
    """20. A real-shape Video-Depth-Anything-Small checkpoint (original
    naming, F16, seeded) written by the port's writer as one file and as
    three shards with an index: `build_bound(..., checkpoint=path)` on the
    card holds the tensors the CPU load holds, and the CLI runs
    `--model Video-Depth-Anything-Small --checkpoint <index>` on a 4K
    synthetic source into the null sink (12 K2 and one K1 a frame)."""
    import tempfile

    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.models import safetensors_io

    spec = get_spec(CKPT_MODEL)
    out = {}
    with tempfile.TemporaryDirectory(prefix="d2s_smoke_ckpt_") as tmp:
        tmp = Path(tmp)
        arrays = vda_original_arrays(np, spec, SEED + 7)
        (tmp / "sharded").mkdir()
        t0 = time.perf_counter()
        single = tmp / "model.safetensors"
        safetensors_io.save_file(arrays, single)
        index = safetensors_io.save_sharded(arrays, tmp / "sharded", shards=3)
        out["write_s"] = time.perf_counter() - t0
        out["params"] = int(sum(a.size for a in arrays.values()))
        out["bytes"] = single.stat().st_size
        ref = None
        for layout, path in (("single", single), ("sharded", index)):
            t0 = time.perf_counter()
            on_card, _ = build_bound(CKPT_MODEL, device=dev, dtype=torch.float32,
                                     checkpoint=str(path))
            load_s = time.perf_counter() - t0
            on_cpu, _ = build_bound(CKPT_MODEL, device="cpu", checkpoint=str(path))
            card_sd = {k: v.cpu() for k, v in on_card.state_dict().items()}
            cpu_sd = on_cpu.state_dict()
            ref = ref or cpu_sd
            raw = safetensors_io.load_tensors(path, dev)
            ok = (set(card_sd) == set(cpu_sd) == set(ref)
                  and all(torch.equal(card_sd[k], cpu_sd[k]) and torch.equal(cpu_sd[k], ref[k])
                          for k in cpu_sd)
                  and len(raw) == len(arrays)
                  and all(torch.equal(raw[k].cpu(), torch.from_numpy(arrays[k])) for k in arrays))
            log(f"[checkpoint] {CKPT_MODEL}, {out['params']} parameters as F16 "
                f"({out['bytes'] / 1e6:.1f} MB), {layout}: build_bound on the card "
                f"{load_s:.2f} s; {len(card_sd)} tensors equal to the CPU load (and to the "
                f"single file's), the raw tensors read onto the card equal to the written "
                f"ones {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"checkpoint {layout}: the card's load differs from the CPU's")
            out[layout] = dict(load_s=load_s, tensors=len(card_sd))
            del on_card, on_cpu, raw
        run = CliRun(counters)
        rc = run(["--settings", str(cli_settings(out_dir)), "--model", CKPT_MODEL,
                  "--checkpoint", index, "--source", "synthetic",
                  "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null",
                  "--frames", str(FRAMES), "--stop-file", str(out_dir / "stop.request"),
                  "--stats-every", "0"])
    _, _, sink, _ = run.parts
    eng = run.engine
    want_shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    ok = rc == 0 and sink.frames >= 1 and sink.last_shape == want_shape
    log(f"[checkpoint] python -m desktop2stereo_tpu_torch.cli --model {CKPT_MODEL} "
        f"--checkpoint <index> --source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} "
        f"--sink null --frames {FRAMES}: exit {rc}; {eng.frames} frames run, {sink.frames} "
        f"delivered {sink.last_shape} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli with --checkpoint: exit code or output off")
    out["cli"] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames,
                      launches=run.check_launches("checkpoint", spec.dims[1], CLI_WARM_FRAMES))
    return out


DA3_MODEL = "DA3-LARGE"
DA3_MONO_MODEL = "DA3MONO-LARGE"
DA3_NESTED_MODEL = "DA3NESTED-GIANT-LARGE"
DA3_RES = 504           # the top of the DA3 menu: a 280x504 input, 721 tokens
DA3_INPUT = (280, 504)
DA3_SHORT_FRAMES = 10   # int8 and NESTED runs
# int8 against bf16 DA3-LARGE on one model input: the JAX package's bound
# for the DA3 family (tests/test_quant.py, DA3-SMALL on the CPU)
INT8_DA3_MIN_CORR = 0.99


# DA3MONO's raw outputs, card bf16 vs CPU f32 on one model input: the depth
# over the reference's non-sky pixels, normalised as the metric post does
# (1/d, percentile clip), under phase 6's depth bound; the sky masks may
# disagree on at most this share of pixels
REF_SKY_MASK_DISAGREE = 0.03


def sky_reference_check(torch, D3, normalize_depth, name, card_net, cpu_net, model_in, dev,
                        dtype):
    """predict(depth, sky) of the mono preset on the card and on the CPU:
    the depth where the CPU's mask says non-sky (what the sky fill would
    hide in the frame's output), the masks' agreement, and the sky share."""
    with torch.inference_mode():
        c = card_net.predict(model_in.to(dev, dtype), ("depth", "sky"))
        r = cpu_net.predict(model_in.float().cpu(), ("depth", "sky"))
    dc, sc = c["depth"].float().cpu()[0, 0], c["sky"].float().cpu()[0, 0]
    dr, sr = r["depth"][0, 0], r["sky"][0, 0]
    non_sky = sr < D3.SKY_THRESHOLD
    err = (normalize_depth(torch.where(non_sky, dc, 0.0), metric=True)
           - normalize_depth(torch.where(non_sky, dr, 0.0), metric=True)).abs()[non_sky]
    ref = {"sky_share_cpu": 1.0 - non_sky.float().mean().item(),
           "non_sky_pixels": int(non_sky.sum().item()),
           "mask_disagree": ((sc < D3.SKY_THRESHOLD) != non_sky).float().mean().item(),
           "non_sky_depth_mean_abs": err.mean().item() if err.numel() else float("nan"),
           "non_sky_depth_max_abs": err.max().item() if err.numel() else float("nan")}
    ok = (bool(torch.isfinite(dc).all()) and err.numel() > 0
          and ref["non_sky_depth_mean_abs"] <= REF_DEPTH_MEAN_ABS
          and ref["mask_disagree"] <= REF_SKY_MASK_DISAGREE)
    log(f"[reference] {name} raw depth and sky, model input {list(model_in.shape)}, card bf16 "
        f"vs CPU f32: sky share {ref['sky_share_cpu']:.4f} ({ref['non_sky_pixels']} non-sky "
        f"pixels); masks disagree on {ref['mask_disagree']:.2e} (tol {REF_SKY_MASK_DISAGREE}); "
        f"normalised non-sky depth mean {ref['non_sky_depth_mean_abs']:.4f} "
        f"(tol {REF_DEPTH_MEAN_ABS}) max {ref['non_sky_depth_max_abs']:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"reference {name}: the raw depth or sky mask disagrees with the CPU")
    return ref


def finite_share(torch, net, program, frame_np, dev):
    """The model's raw depth on one 4K frame's model input, and the share
    of its values that are finite (exp heads on random weights can
    overflow)."""
    with torch.inference_mode():
        _, model_in = program.program.preprocess(torch.from_numpy(frame_np).to(dev))
        raw = net(model_in)
        return model_in, raw, torch.isfinite(raw).float().mean().item()


def da3_phases(np, torch, programs, build_bound, drive, driven, trace, paths, frames, counters,
               policy, dev, card, out_dir):
    """21-26: the Depth-Anything-3 family at depth resolution 504 on 4K
    Half-SBS (the fused tail): DA3-LARGE (exact launches, stage ms, peak
    memory, the share of finite depth, a traced frame without the ray branch
    or the camera decoder, beside a traced full-output call that runs them);
    DA3MONO-LARGE (the sky post's ms); card bf16 against CPU f32 for both;
    int8 DA3-LARGE (K4, correlation with bf16); DA3NESTED-GIANT-LARGE (64 K2
    a frame, build s, peak memory); the CLI with `--model DA3-LARGE`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from desktop2stereo_tpu_torch.models import da3 as D3
    from desktop2stereo_tpu_torch.ops.depth_post import normalize_depth

    out = {}
    shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)

    def build(name, **kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net, net_spec = build_bound(name, device=dev, dtype=policy.compute_dtype, seed=SEED, **kw)
        return net, net_spec, time.perf_counter() - t0

    # -- 21. DA3-LARGE @504, 4K Half-SBS ------------------------------------
    net, spec, build_s = build(DA3_MODEL)
    layers = len(net.backbone.layer)
    cfg = drive("da3", net, "Half-SBS", "high", shape, {"attention": layers, "dibr_pair": 1},
                net_spec=spec, res=DA3_RES)
    program = driven.pop("da3")
    mi_shape = programs.ema_shape(cfg, spec, *FRAME_SHAPE[:2])
    if tuple(mi_shape) != DA3_INPUT:
        raise AssertionError(f"da3: model input {mi_shape}, want {DA3_INPUT}")
    model_in, raw, finite = finite_share(torch, net, program, frames[0], dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out["large"] = dict(build_s=build_s, peak_mem_gb=peak, finite_share=finite,
                        model_input=list(model_in.shape))
    log(f"[da3] {DA3_MODEL} built in {build_s:.1f} s; model input {list(model_in.shape)} "
        f"({DA3_INPUT[0] // 14 * DA3_INPUT[1] // 14 + 1} tokens); raw depth finite on "
        f"{finite:.6f} of {raw.numel()} values, range {raw.float().nan_to_num().min().item():.4g}"
        f"..{raw.float().nan_to_num().max().item():.4g}; peak device memory {peak:.2f} GB; {card}")

    # the traced frame runs neither the ray branch nor the camera decoder:
    # both are bracketed by record_function ranges, and a full-output call
    # (every output of the preset) traced beside it shows the ranges with
    # their kernels
    spans = ("da3_ray", "da3_cam_dec")
    with _Probe(torch, D3.DA3DualDPT, "_aux", "da3_ray"), \
            _Probe(torch, D3.DA3CameraDec, "forward", "da3_cam_dec"):
        tr = trace("da3", net, spec, cfg, "engine", {"K2 attention": layers, "K1 dibr_pair": 1},
                   spans=spans)
        with torch.inference_mode():
            for _ in range(3):
                net.predict(model_in)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("frame"):
                    full = net.predict(model_in)
                torch.cuda.synchronize()
    path = out_dir / "trace_da3_full_outputs.json"
    prof.export_chrome_trace(str(path))

    def events_of(p):
        data = json.loads(p.read_text())
        return data["traceEvents"] if isinstance(data, dict) else data

    def host_ranges(events, label):
        return sum(1 for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == label)

    full_events, frame_events = events_of(path), events_of(out_dir / "trace_da3.json")
    full_tr = summarize_trace(full_events, spans)
    conv_frame = tr["groups"].get("convolution", {}).get("calls", 0)
    conv_full = full_tr["groups"].get("convolution", {}).get("calls", 0)
    ranges = {k: (host_ranges(frame_events, k), host_ranges(full_events, k)) for k in spans}
    ok = (all(f == 0 and g == 1 for f, g in ranges.values())
          and all(tr["spans"][k] is None for k in spans) and set(full) == set(D3.ANYVIEW_OUTPUTS))
    log(f"[da3] traced 4K frame: da3_ray and da3_cam_dec ranges on the host "
        + ", ".join(f"{k} {f}" for k, (f, _) in ranges.items())
        + f" (the ray branch and the camera decoder did not run), {conv_frame} convolution "
        f"kernels; a traced predict(every output) on the same input: host ranges "
        + ", ".join(f"{k} {g}" for k, (_, g) in ranges.items()) + "; on the card " + ", ".join(
            f"{k} {v['ms']:.3f} ms in {v['calls']} kernels" if v else f"{k} not separable"
            for k, v in full_tr["spans"].items())
        + f", {conv_full} convolution kernels, busy {full_tr['busy_ms']:.3f} ms "
        f"{'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("da3: the frame ran a dead branch, or the full call missed one")
    out["large"].update(trace=tr, full_outputs_trace=dict(
        busy_ms=full_tr["busy_ms"], spans=full_tr["spans"], groups=full_tr["groups"]))
    del program, full, raw

    # -- 22. DA3MONO-LARGE: the DPT head with the sky post -------------------
    mono, mono_spec, mono_build_s = build(DA3_MONO_MODEL)
    mono_cfg = drive("da3_mono", mono, "Half-SBS", "high", shape,
                     {"attention": layers, "dibr_pair": 1}, net_spec=mono_spec, res=DA3_RES)
    program = driven.pop("da3_mono")
    _, raw, mono_finite = finite_share(torch, mono, program, frames[0], dev)
    with _Probe(torch, D3, "sky_to_max_depth") as probe:
        per_frame = []
        for i in range(11):
            probe.records.clear()
            program(frames[i % len(frames)])
            torch.cuda.synchronize()
            if i:
                per_frame.append(probe.records[0][0].elapsed_time(probe.records[0][1]))
    with torch.inference_mode():
        sky = mono.predict(model_in, ("depth", "sky"))["sky"]
    sky_share = (sky >= 0.3).float().mean().item()
    out["mono"] = dict(build_s=mono_build_s, finite_share=mono_finite,
                       sky_post_ms=statistics.median(per_frame), sky_share=sky_share,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[da3] {DA3_MONO_MODEL}: sky post (two sorts of {raw[0].numel()} values and the "
        f"fill, on the card) {out['mono']['sky_post_ms']:.3f} ms (CUDA events around it in "
        f"the frame, eager, median of 10); sky share {sky_share:.4f}; raw depth finite on "
        f"{mono_finite:.6f}; built in {mono_build_s:.1f} s; {card}")
    del program, raw, sky

    # -- 23. card bf16 against CPU f32 on a small frame ----------------------
    small = synthetic_frames(np, 1, 216, 384, SEED + 1)[0]
    out["reference"] = {}
    for name, card_net, net_cfg in ((DA3_MODEL, net, cfg), (DA3_MONO_MODEL, mono, mono_cfg)):
        cpu_net, net_spec = build_bound(name, device="cpu", dtype=torch.float32, seed=SEED)
        card_prog = programs.ProgramCache(net_cfg, card_net, net_spec,
                                          compute_dtype=policy.compute_dtype)
        cpu_prog = programs.ProgramCache(net_cfg, cpu_net, net_spec, compute_dtype=torch.float32)
        out["reference"][name] = reference_check(torch, f"{name} @{DA3_RES}", card_prog,
                                                 cpu_prog, small)
        if name == DA3_MONO_MODEL:
            # the frame's depth is mostly the sky fill on random weights:
            # hold the raw depth and the sky mask as well
            _, cpu_in = cpu_prog.program.preprocess(torch.from_numpy(small))
            out["reference"][name + " raw"] = sky_reference_check(
                torch, D3, normalize_depth, f"{name} @{DA3_RES}", card_net, cpu_net, cpu_in,
                dev, policy.compute_dtype)
        del cpu_net, cpu_prog, card_prog
    del mono

    # -- 24. int8 DA3-LARGE -------------------------------------------------
    net_q, _, q_build_s = build(DA3_MODEL, quant="int8")
    with torch.inference_mode():
        raw_f = net(model_in)[0].float()
        raw_q = net_q(model_in)[0].float()
    both = torch.stack([raw_f.flatten(), raw_q.flatten()])
    corr = torch.corrcoef(both)[0, 1].item()
    rel = ((raw_q - raw_f).abs().max() / raw_f.abs().max().clamp_min(1e-6)).item()
    ok = bool(torch.isfinite(both).all()) and corr > INT8_DA3_MIN_CORR
    log(f"[da3] int8 {DA3_MODEL} against bf16 on one {list(model_in.shape)} model input: "
        f"correlation {corr:.5f} (min {INT8_DA3_MIN_CORR}), max rel err {rel:.4f}; built in "
        f"{q_build_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8 DA3 does not track the bf16 model")
    out["int8"] = dict(corr=corr, max_rel_err=rel, build_s=q_build_s)
    drive("da3_int8", net_q, "Half-SBS", "high", shape,
          {"attention": layers, "quant_matmul": 4 * layers, "dibr_pair": 1}, net_spec=spec,
          n_frames=DA3_SHORT_FRAMES, res=DA3_RES)
    driven.pop("da3_int8")
    del net_q, raw_f, raw_q, both

    # -- 25. DA3NESTED-GIANT-LARGE ---------------------------------------------
    del net
    nested, nested_spec, nested_build_s = build(DA3_NESTED_MODEL)
    n_layers = len(nested.da3.backbone.layer) + len(nested.da3_metric.backbone.layer)
    drive("da3_nested", nested, "Half-SBS", "high", shape,
          {"attention": n_layers, "dibr_pair": 1}, net_spec=nested_spec,
          n_frames=DA3_SHORT_FRAMES, res=DA3_RES)
    program = driven.pop("da3_nested")
    _, raw, nested_finite = finite_share(torch, nested, program, frames[0], dev)
    params = sum(p.numel() for p in nested.parameters())
    out["nested"] = dict(build_s=nested_build_s, layers=n_layers, params=params,
                         finite_share=nested_finite,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[da3] {DA3_NESTED_MODEL}: {params} parameters (ViT-G {len(nested.da3.backbone.layer)}"
        f" layers with SwiGLU + ViT-L {len(nested.da3_metric.backbone.layer)}), built in "
        f"{nested_build_s:.1f} s (drawn in f32 on the host, moved to the card in bf16); raw "
        f"depth finite on {nested_finite:.6f}; peak device memory "
        f"{out['nested']['peak_mem_gb']:.2f} GB; {card}")
    del nested, program, raw
    torch.cuda.empty_cache()

    # -- 26. the CLI with --model DA3-LARGE ------------------------------------
    run = CliRun(counters)
    rc = run(["--settings", str(cli_settings(out_dir)), "--model", DA3_MODEL, "--depth-res",
              str(DA3_RES), "--source", "synthetic", "--size",
              f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null", "--frames", str(FRAMES),
              "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    _, _, sink, _ = run.parts
    eng = run.engine
    ok = rc == 0 and sink.frames >= 1 and sink.last_shape == shape
    log(f"[cli] python -m desktop2stereo_tpu_torch.cli --model {DA3_MODEL} --depth-res "
        f"{DA3_RES} --source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} --sink null "
        f"--frames {FRAMES}: exit {rc}; {eng.frames} frames run, {sink.frames} delivered "
        f"{sink.last_shape} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli with --model DA3-LARGE: exit code or output off")
    out["cli"] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames,
                      launches=run.check_launches("da3", layers, CLI_WARM_FRAMES))
    out["paths"] = {k: paths[k] for k in ("da3", "da3_mono", "da3_int8", "da3_nested")}
    return out


def main() -> int:
    if not (ROOT / "desktop2stereo_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no desktop2stereo_tpu_torch package beside {__file__}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on an NVIDIA GPU and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.ops import stereo as S
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.kernels import dibr as K1
    from desktop2stereo_tpu_torch.ops.kernels import dibr_fill as K5
    from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
    from desktop2stereo_tpu_torch.ops.kernels import warp as K3
    from desktop2stereo_tpu_torch.pipeline import programs
    from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine

    report = {}
    # launch counters by kernel (K1's two entry points share one)
    counters = {"attention": K2.KERNEL, "dibr_pair": K1.KERNEL, "warp": K3.KERNEL,
                "dibr_fill": K5.KERNEL, "quant_matmul": K4.KERNEL}

    # -- 1. device ---------------------------------------------------------
    policy = cuda_policy(0, allow_tf32=False)
    dev = policy.device
    card = card_line()
    log(card)
    log(f"[device] {policy.name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"compute {policy.compute_dtype}, TF32 matmul/cudnn "
        f"{torch.backends.cuda.matmul.allow_tf32}/{torch.backends.cudnn.allow_tf32}; "
        f"peaks for the bound {peaks(policy.name)}")
    report["card"] = card
    report["host_packages"] = host_packages()
    log("[device] host packages the sinks and sources import when made: " + ", ".join(
        f"{k} {v}" for k, v in report["host_packages"].items()))

    # -- 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    libs = list(counters.values())
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.lib, libs))  # builds (if missing) and loads
    build_s = time.perf_counter() - t0
    log("[build] " + ", ".join(
        f"{k.source.name} {k.build_seconds:.2f} s" if k.build_seconds is not None
        else f"{k.source.name} already built" for k in libs)
        + f" (nvcc in parallel); all loaded in {build_s:.2f} s")
    report["build_s"] = build_s

    # -- 3. kernel parity ----------------------------------------------------
    worst = {"dibr_pair_half": 0.0, "dibr_pair_eyes": 0.0, "attention": 0.0,
             "warp": 0.0, "dibr_fill": 0.0, "quant_matmul": 0.0}
    for (eh, ew) in (EYE, (50, 200), (96, 256)) + DIBR_EDGES:
        rng = np.random.default_rng(eh + ew)
        rgb = torch.from_numpy(rng.random((3, eh, ew), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((eh, ew), dtype=np.float32) if eh > 4
                               else edgy_depth(np, rng, eh, ew)).to(dev)
        for feather in (0.0, S.FEATHER_WIDTH):
            for arrangement in ("sbs", "tab"):
                kw = dict(ipd=IPD, depth_strength=STRENGTH, convergence=0.01,
                          feather=feather, arrangement=arrangement)
                got = K1.dibr_pair_half(rgb, dep, **kw)
                want = K1.dibr_pair_half_ref(rgb, dep, **kw)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.uint8:
                    raise AssertionError(f"dibr {got.dtype} {tuple(got.shape)} vs {tuple(want.shape)}")
                diff = (got.int() - want.int()).abs()
                lsb, share = int(diff.max().item()), (diff > 0).float().mean().item()
                worst["dibr_pair_half"] = max(worst["dibr_pair_half"], lsb)
                check_u8(f"dibr half eye {eh}x{ew} feather={feather} {arrangement}", lsb, share,
                         n=diff.numel())

    for (h, w) in (FULL, (50, 200), (96, 256)) + DIBR_EDGES:
        rng = np.random.default_rng(h * w)
        rgb = torch.from_numpy(rng.random((3, h, w), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((h, w), dtype=np.float32) if h > 4
                               else edgy_depth(np, rng, h, w)).to(dev)
        kw = dict(ipd=IPD, depth_strength=STRENGTH, convergence=0.01)
        got = K1.dibr_pair_eyes(rgb, dep, **kw)
        want = K1.dibr_pair_eyes_ref(rgb, dep, **kw)
        torch.cuda.synchronize()
        for side, g, wt in zip(("left", "right"), got, want):
            if g.shape != (3, h, w) or g.dtype != torch.float32:
                raise AssertionError(f"dibr eyes {g.dtype} {tuple(g.shape)}")
            lsb, share = u8_diff(torch, g, wt)
            f32 = (g - wt).abs().max().item()
            worst["dibr_pair_eyes"] = max(worst["dibr_pair_eyes"], f32)
            check_u8(f"dibr eyes {h}x{w} {side}", lsb, share, f"; f32 max abs {f32:.3e}",
                     n=g.numel())

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for shape, views in ((ATTN_SHAPE, True), (ATTN_SHAPE, False),
                         ((2, 130, 4, 64), False), ((1, 1370, 12, 64), False)):
        B, N, H, D = shape
        if views:  # the encoder's strided q/k/v views of one qkv projection
            qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
        else:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
        got = K2.attention(q, k, v).float()
        want = K2.attention_ref(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst["attention"] = max(worst["attention"], err)
        ok = err <= ATTN_MAX_ABS and got.shape == want.shape
        log(f"[parity] attention {list(shape)}{' qkv views' if views else ''} bf16: "
            f"max abs err {err:.3e} (tol {ATTN_MAX_ABS:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("attention kernel disagrees with its plain version")

    def fast_px(dep):
        """The fast compositor's reflected warp position, left eye."""
        W = dep.shape[1]
        shifts = -dep * STRENGTH * (IPD * W) * S.DEPTH_STRENGTH_SBS
        base = torch.arange(W, dtype=torch.float32, device=dep.device)[None, :]
        return S._reflect_coords(base + shifts, W).contiguous()

    for (h, w, c) in ((*FULL, 3), (50, 200, 3), (96, 256, 3), (9, 1, 3)):
        rng = np.random.default_rng(h + w + c)
        img = torch.from_numpy(rng.random((h, w, c), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        px = fast_px(dep)
        got = K3.horizontal_sample(img, px)
        want = K3.horizontal_sample_ref(img, px)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst["warp"] = max(worst["warp"], err)
        ok = err <= WARP_MAX_ABS and got.shape == want.shape
        log(f"[parity] warp [{h},{w},{c}] reflected px at strength {STRENGTH}: max abs err "
            f"{err:.3e} (tol {WARP_MAX_ABS:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("warp kernel disagrees with its plain version")

    def fill_inputs(h, w, seed, eye=-IPD / 2):
        """rgb, RAW depth, conf and clamped px as dibr_render builds them."""
        rng = np.random.default_rng(seed)
        rgb = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((h, w), dtype=np.float32) if h > 4
                               else edgy_depth(np, rng, h, w)).to(dev)
        _, px, _, conf = S.dibr_geometry(dep, eye, STRENGTH, 0.01)
        return rgb, dep, conf.contiguous(), px.clamp(0.0, w - 1.0).contiguous()

    for (h, w) in (FULL, (50, 200), (96, 256)) + DIBR_EDGES:
        args = fill_inputs(h, w, seed=h + 2 * w)
        for sign in (-1.0, 1.0):
            got = K5.dibr_warp_fill_blend(*args, sweep_sign=sign)
            want = K5.dibr_warp_fill_blend_ref(*args, sweep_sign=sign)
            torch.cuda.synchronize()
            lsb, share = u8_diff(torch, got, want)
            f32 = (got - want).abs().max().item()
            worst["dibr_fill"] = max(worst["dibr_fill"], f32)
            check_u8(f"dibr_fill {h}x{w} sweep {sign:+.0f}", lsb, share,
                     f"; f32 max abs {f32:.3e}", n=got.numel())

    def check_quant(label, got, want):
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        worst["quant_matmul"] = max(worst["quant_matmul"], err)
        ok = got.shape == want.shape and got.dtype == want.dtype and err <= QUANT_MAX_ABS
        log(f"[parity] quant_matmul {label}: max abs err {err:.3e} (tol {QUANT_MAX_ABS}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"quant_matmul {label}: kernel disagrees with its plain version")

    M_TOK = ATTN_SHAPE[1]
    for name, kin, fout in VIT_L_DENSE:
        args = dense_inputs(np, torch, dev, M_TOK, kin, fout, torch.bfloat16, True,
                            seed=kin + fout)
        check_quant(f"{name} [{M_TOK},{kin}]x[{kin},{fout}] bf16 + bias",
                    K4.quant_dense(*args), K4.quant_dense_ref(*args))
    for rows in (1, 7, 130):
        for kin in (64, 256):
            for fout in (96, 200):
                args = dense_inputs(np, torch, dev, rows, kin, fout, torch.float32, False,
                                    seed=rows * kin + fout)
                check_quant(f"[{rows},{kin}]x[{kin},{fout}] f32 no bias",
                            K4.quant_dense(*args), K4.quant_dense_ref(*args))
    x, wq, scale, bias = dense_inputs(np, torch, dev, 130, 256, 200, torch.bfloat16, True, seed=9)
    rs = x.float().abs().amax(dim=-1, keepdim=True) / 200.0  # clips the largest values
    check_quant("row_scale [130,256]x[256,200] bf16", K4.quant_dense(x, wq, scale, bias, rs),
                K4.quant_dense_ref(x, wq, scale, bias, rs))
    # int32 mode: integer-valued activations and row_scale 1, so q = x
    x, wq, scale, _ = dense_inputs(np, torch, dev, M_TOK, 1024, 4096, torch.float32, False, seed=10)
    xi = x.clamp(-127, 127).round().to(torch.bfloat16)
    ones = torch.ones(M_TOK, 1, device=dev)
    acc = K4.quant_dense(xi, wq, scale, row_scale=ones, out_dtype=torch.int32)
    check_quant(f"int32 [{M_TOK},1024]x[1024,4096]", acc,
                K4.quant_dense_ref(xi, wq, scale, row_scale=ones, out_dtype=torch.int32))
    exact = (xi.double() @ wq.double().T).to(torch.int64)
    if not torch.equal(acc.to(torch.int64), exact):
        raise AssertionError("quant_matmul int32 mode differs from the exact integer product")
    log("[parity] quant_matmul int32 mode equals the exact int64 product")
    del x, xi, wq, scale, acc, exact

    # -- 4. kernel times -----------------------------------------------------
    timing = {}
    rng = np.random.default_rng(1)
    rgb_e = torch.from_numpy(rng.random((3, *EYE), dtype=np.float32) * 255).to(dev)
    dep_e = torch.from_numpy(rng.random(EYE, dtype=np.float32)).to(dev)
    dkw = dict(ipd=IPD, depth_strength=STRENGTH, convergence=0.0)
    t = time_both(torch, {"plain": lambda: K1.dibr_pair_half_ref(rgb_e, dep_e, **dkw),
                          "kernel": lambda: K1.dibr_pair_half(rgb_e, dep_e, **dkw)})
    px_e = EYE[0] * EYE[1]
    timing["dibr_pair_half"] = dict(t, library=None, shape=f"eye {EYE[0]}x{EYE[1]} Half-SBS",
                                    bound=bound_ms(policy.name, 4 * 4 * px_e + 2 * 3 * px_e,
                                                   OPS_PER_PX["dibr_pair"] * px_e, "f32"))
    del rgb_e, dep_e

    rgb_f = torch.from_numpy(rng.random((3, *FULL), dtype=np.float32) * 255).to(dev)
    dep_f = torch.from_numpy(rng.random(FULL, dtype=np.float32)).to(dev)
    t = time_both(torch, {"plain": lambda: K1.dibr_pair_eyes_ref(rgb_f, dep_f, **dkw),
                          "kernel": lambda: K1.dibr_pair_eyes(rgb_f, dep_f, **dkw)})
    px_f = FULL[0] * FULL[1]
    timing["dibr_pair_eyes"] = dict(t, library=None, shape=f"frame {FULL[0]}x{FULL[1]} eyes f32",
                                    bound=bound_ms(policy.name, 4 * 4 * px_f + 2 * 3 * 4 * px_f,
                                                   OPS_PER_PX["dibr_pair"] * px_f, "f32"))
    del rgb_f, dep_f

    B, N, H, D = ATTN_SHAPE
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t_.unflatten(-1, (H, D)) for t_ in qkv.split(H * D, dim=-1))
    qh, kh, vh = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))  # [B,H,N,D]
    t = time_both(torch, {"plain": lambda: K2.attention_ref(q, k, v),
                          "kernel": lambda: K2.attention(q, k, v),
                          "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)})
    timing["attention"] = dict(t, shape=f"{list(ATTN_SHAPE)} bf16 qkv views",
                               bound=bound_ms(policy.name, 4 * B * N * H * D * 2,
                                              4 * B * H * N * N * D, "bf16"))
    del qkv, q, k, v, qh, kh, vh

    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.random((*FULL, 3), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random(FULL, dtype=np.float32)).to(dev)
    px = fast_px(dep)
    # the library yardstick: grid_sample on NCHW with the row held fixed
    img_nchw = img.permute(2, 0, 1)[None].contiguous()
    gy = torch.linspace(-1.0, 1.0, FULL[0], device=dev)[:, None].expand(FULL)
    grid = torch.stack([px / (FULL[1] - 1) * 2.0 - 1.0, gy], dim=-1)[None].contiguous()
    t = time_both(torch, {
        "plain": lambda: K3.horizontal_sample_ref(img, px),
        "kernel": lambda: K3.horizontal_sample(img, px),
        "library": lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                         padding_mode="border", align_corners=True)})
    timing["warp"] = dict(t, shape=f"[{FULL[0]},{FULL[1]},3] f32",
                          bound=bound_ms(policy.name, (3 * 4 * 2 + 4) * px_f,
                                         OPS_PER_PX["warp3"] * px_f, "f32"))
    del img, dep, px, img_nchw, grid, gy

    args = fill_inputs(*FULL, seed=3)
    t = time_both(torch, {"plain": lambda: K5.dibr_warp_fill_blend_ref(*args, sweep_sign=-1.0),
                          "kernel": lambda: K5.dibr_warp_fill_blend(*args, sweep_sign=-1.0)})
    timing["dibr_fill"] = dict(t, library=None, shape=f"frame {FULL[0]}x{FULL[1]} one eye",
                               bound=bound_ms(policy.name, (3 * 4 * 2 + 3 * 4) * px_f,
                                              OPS_PER_PX["dibr_fill"] * px_f, "f32"))
    del args
    for name, kin, fout in VIT_L_DENSE:
        x, wq, scale, bias = dense_inputs(np, torch, dev, M_TOK, kin, fout, torch.bfloat16,
                                          True, seed=kin + fout)
        xq = x.float().clamp(-127, 127).round()
        xi, xq8 = xq.to(torch.bfloat16), xq.to(torch.int8)
        ones = torch.ones(M_TOK, 1, device=dev)
        wt = wq.t()  # [K, F] column-major, the layout cuBLASLt's int8 product takes
        w_bf16 = torch.randn(fout, kin, generator=gen, device=dev).bfloat16()
        b_bf16 = bias.bfloat16()
        t = time_both(torch, {
            "plain": lambda: K4.quant_dense_ref(x, wq, scale, bias),
            "kernel": lambda: K4.quant_dense(x, wq, scale, bias),
            "kernel_int32": lambda: K4.quant_dense(xi, wq, scale, row_scale=ones,
                                                   out_dtype=torch.int32),
            "library": lambda: torch._int_mm(xq8, wt),
            "linear_bf16": lambda: F.linear(x, w_bf16, b_bf16)})
        timing[f"quant_matmul_{name}"] = dict(
            t, shape=f"{name} [{M_TOK},{kin}] bf16 x [{fout},{kin}] int8 + bias",
            bound=bound_ms(policy.name, 2 * M_TOK * kin + fout * kin + 8 * fout
                           + 2 * M_TOK * fout, 2 * M_TOK * kin * fout, "int8"))
        del x, wq, scale, bias, xq, xi, xq8, ones, wt, w_bf16, b_bf16
    for name, tm in timing.items():
        ea = tm["eager"]
        lib = (f", library {tm['library']:.4f} (eager {ea['library']:.4f})"
               if tm.get("library") is not None else "")
        if "kernel_int32" in tm:
            lib += (f" (torch._int_mm on int8 x; K4's int32 mode with row_scale 1 "
                    f"{tm['kernel_int32']:.4f}), bf16 F.linear {tm['linear_bf16']:.4f} "
                    f"(eager {ea['linear_bf16']:.4f})")
        log(f"[time] {name} {tm['shape']}: kernel {tm['kernel']:.4f} ms (eager "
            f"{ea['kernel']:.4f}), plain {tm['plain']:.4f} (eager {ea['plain']:.4f}){lib}, "
            f"bound {tm['bound'][0]:.4f} ({tm['bound'][1]}) ms per call (device-only: CUDA "
            f"graphs of 10 calls; eager: events around 10 calls, host included; median of "
            f"{TIMED_RUNS}; {card})")
    torch.cuda.empty_cache()

    # -- 5. flagship path: Half-SBS, fused tail -------------------------------
    t0 = time.perf_counter()
    model, spec = build_bound(FLAGSHIP_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    model_build_s = time.perf_counter() - t0
    layers = len(model.backbone.layer)  # 24 for ViT-L
    frames = synthetic_frames(np, 4, FRAME_SHAPE[0], FRAME_SHAPE[1], SEED)
    paths = {}
    driven = {}  # path name → its ProgramCache, for the checks after a run

    def drive(name, net, mode, quality, want_shape, want, net_spec=None, n_frames=FRAMES,
              res=518):
        """Warm up, run `n_frames` frames of model `net` at depth resolution
        `res` through FrameEngine, check the counts `want` (kernel →
        launches per frame), time the stages."""
        net_spec = net_spec or spec
        cfg = config(programs, mode, quality, net_spec.name, res)
        program = programs.ProgramCache(cfg, net, net_spec, compute_dtype=policy.compute_dtype)
        warm = program.warmup(FRAME_SHAPE)
        source = SaturatingSource(frames, n_frames)
        sink = CheckingNullSink(want_shape)
        fps, counts, stats = run_engine(FrameEngine, program, source, sink, counters, n_frames)
        log(f"[{name}] {net_spec.name} {mode} {quality}: {n_frames} frames, {sink.count} "
            f"delivered; launches " + ", ".join(
                f"{k} {n} (want {want.get(k, 0) * n_frames})" for k, n in counts.items()))
        if any(counts[k] != want.get(k, 0) * n_frames for k in counts):
            raise AssertionError(f"{name}: a kernel was not launched as the path needs")
        driven[name] = program
        generic = not program.program.fused(*FRAME_SHAPE[:2])
        stages, out = stage_times(torch, programs, program, frames[0], cfg, net_spec, dev,
                                  generic)
        if tuple(out.shape) != want_shape or out.dtype != torch.uint8:
            raise AssertionError(f"{name}: step output {out.dtype} {tuple(out.shape)}")
        log(f"[{name}] engine {fps:.2f} frames/s over {n_frames} frames (fps counter "
            f"{stats.fps:.2f}); stage ms " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f" (CUDA events at the stage seams, host launch gaps included, median of "
            f"{TIMED_RUNS}); first calls " + ", ".join(f"{k} {v:.2f}" for k, v in warm.items())
            + f"; {card}")
        paths[name] = dict(mode=mode, quality=quality, engine_fps=fps, fps_counter=stats.fps,
                           stage_ms=stages, warmup_s=warm, launches=counts)
        return cfg

    log(f"[main] {FLAGSHIP_MODEL} built in {model_build_s:.1f} s")
    flagship_cfg = drive("main", model, "Half-SBS", "high", (FRAME_SHAPE[0], FRAME_SHAPE[1], 3),
                         {"attention": layers, "dibr_pair": 1})

    # -- 6. reference on a small frame: card bf16 vs CPU f32 ----------------
    small_frame = synthetic_frames(np, 1, 216, 384, SEED + 1)[0]
    cpu_model, _ = build_bound(FLAGSHIP_MODEL, device="cpu", dtype=torch.float32, seed=SEED)
    refs = {}

    def reference(name, cfg, card_net, cpu_net):
        card_prog = programs.ProgramCache(cfg, card_net, spec, compute_dtype=policy.compute_dtype)
        cpu_prog = programs.ProgramCache(cfg, cpu_net, spec, compute_dtype=torch.float32)
        refs[name] = reference_check(torch, f"{name}: {cfg.display_mode} {cfg.quality}",
                                     card_prog, cpu_prog, small_frame)

    reference("main", flagship_cfg, model, cpu_model)

    # -- 7./8. generic tail, high and fast quality ----------------------------
    full_cfg = drive("generic_high", model, "Full-SBS", "high",
                     (FRAME_SHAPE[0], 2 * FRAME_SHAPE[1], 3), {"attention": layers, "dibr_pair": 1})
    fast_cfg = drive("generic_fast", model, "Half-SBS", "fast",
                     (FRAME_SHAPE[0], FRAME_SHAPE[1], 3), {"attention": layers, "warp": 2})

    # -- 9. mode cycling: every mode twice, switched after each frame -------
    h, w = FRAME_SHAPE[:2]
    shapes = {m: (h, w, 3) for m in DISPLAY_MODES}
    shapes.update({"Full-SBS": (h, 2 * w, 3), "Full-TAB": (2 * h, w, 3)})
    cycle = programs.ProgramCache(config(programs), model, spec,
                                  compute_dtype=policy.compute_dtype)
    n_cycle = 2 * len(DISPLAY_MODES)
    source = LockstepSource(frames, n_cycle)
    sink = CyclingSink(cycle, source, K1.KERNEL, DISPLAY_MODES, shapes)
    for kern in counters.values():
        kern.launches = 0
    engine = FrameEngine(source, cycle, sink, target_fps=0.0)
    t0 = time.perf_counter()
    engine.run(duration=600.0)
    cycle_s = time.perf_counter() - t0
    cycle_counts = {n: kern.launches for n, kern in counters.items()}
    want_k1 = n_cycle - 2  # Depth, twice, runs no DIBR
    log(f"[cycle] {sink.count} frames through all {len(DISPLAY_MODES)} modes twice in "
        f"{cycle_s:.2f} s, each output shape checked; launches "
        + ", ".join(f"{k} {n}" for k, n in cycle_counts.items())
        + f" (want dibr_pair {want_k1}, attention {layers * n_cycle})")
    if (sink.count != n_cycle or cycle_counts["dibr_pair"] != want_k1
            or cycle_counts["attention"] != layers * n_cycle):
        raise AssertionError("mode cycling: frames or launches off")
    report["cycle"] = dict(frames=sink.count, seconds=cycle_s, launches=cycle_counts)
    del cycle, engine

    # -- 10. dibr_render at 4K, both eyes: K5 ---------------------------------
    rng = np.random.default_rng(4)
    rgb = torch.from_numpy(rng.random((*FULL, 3), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random(FULL, dtype=np.float32)).to(dev)
    for kern in counters.values():
        kern.launches = 0
    eyes = [S.dibr_render(rgb, dep, e * IPD / 2, STRENGTH, 0.0) for e in (-1, 1)]
    torch.cuda.synchronize()
    render_counts = {n: kern.launches for n, kern in counters.items()}
    ok = (render_counts["dibr_fill"] == 2 and sum(render_counts.values()) == 2
          and all(bool(torch.isfinite(e).all()) and e.min().item() >= 0.0
                  and e.max().item() <= 255.0 and e.shape == rgb.shape for e in eyes))
    log(f"[dibr_render] both eyes at {FULL[0]}x{FULL[1]}: launches "
        + ", ".join(f"{k} {n}" for k, n in render_counts.items())
        + f" (want dibr_fill 2); outputs finite in [0, 255] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("dibr_render did not run K5 twice, or its output is off")
    del rgb, dep, eyes

    # -- 11. reference for the generic tail ------------------------------------
    reference("generic_high", full_cfg, model, cpu_model)
    reference("generic_fast", fast_cfg, model, cpu_model)
    del cpu_model

    # -- 12. int8 against bf16: one seed, one model input ---------------------
    t0 = time.perf_counter()
    model_q, _ = build_bound(FLAGSHIP_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED,
                             quant="int8")
    int8_build_s = time.perf_counter() - t0
    log(f"[int8] {FLAGSHIP_MODEL} int8 built in {int8_build_s:.1f} s (float draw, "
        f"quantisation on the CPU and the move to the card)")
    with torch.inference_mode():
        fp = programs.FrameProgram(flagship_cfg, model, spec, policy.compute_dtype)
        _, model_in = fp.preprocess(torch.from_numpy(frames[0]).to(dev))
        raw_f = model(model_in)[0].float()
        raw_q = model_q(model_in)[0].float()
    corr = torch.corrcoef(torch.stack([raw_f.flatten(), raw_q.flatten()]))[0, 1].item()
    rel = ((raw_q - raw_f).abs().max() / raw_f.abs().max().clamp_min(1e-6)).item()
    finite = bool(torch.isfinite(raw_q).all())
    ok = finite and corr >= INT8_MIN_CORR
    log(f"[int8] raw depth [{', '.join(map(str, raw_q.shape))}], int8 vs bf16 on the card: "
        f"correlation {corr:.5f} (min {INT8_MIN_CORR}), max rel err {rel:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 model does not track the bf16 model")
    report["int8_vs_bf16"] = dict(corr=corr, max_rel_err=rel, shape=list(raw_q.shape),
                                  model_input=list(model_in.shape))
    del fp, model_in, raw_f, raw_q  # the bf16 model stays for phase 15
    torch.cuda.empty_cache()

    # -- 13. int8 flagship path: Half-SBS, fused tail ------------------------
    drive("int8", model_q, "Half-SBS", "high", (FRAME_SHAPE[0], FRAME_SHAPE[1], 3),
          {"attention": layers, "quant_matmul": 4 * layers, "dibr_pair": 1})

    # -- 14. int8 reference on a small frame: card bf16 vs CPU f32 -----------
    cpu_model_q, _ = build_bound(FLAGSHIP_MODEL, device="cpu", dtype=torch.float32, seed=SEED,
                                 quant="int8")
    reference("int8", flagship_cfg, model_q, cpu_model_q)
    report["int8_vs_bf16"]["reference"] = refs["int8"]
    del cpu_model_q

    # -- 15. one traced flagship frame and one traced int8 frame --------------
    from torch.profiler import ProfilerActivity, profile, record_function

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def trace(name, net, net_spec, cfg, staging, want, spans=()):
        """One traced 4K frame of `net`, after a warm-up and 3 untraced
        frames (a stateful model's carry is warm: the traced frame runs
        `step`), its kernel instances checked against `want`."""
        program = programs.ProgramCache(cfg, net, net_spec, compute_dtype=policy.compute_dtype)
        program.warmup(FRAME_SHAPE)
        engine = None
        if staging == "engine":
            # as FrameEngine runs a frame: _dispatch uploads it through the
            # pinned staging ring, runs the program and enqueues the copies
            # back into pinned memory; _finish waits on the `done` event
            engine = FrameEngine(None, program, CheckingNullSink(None), target_fps=0.0)

            def frame():
                t0 = time.perf_counter()
                engine._finish((*engine._dispatch(frames[1]), t0, t0))
        else:
            def frame():  # pageable upload from numpy, .cpu() downloads
                sbs, depth = program(frames[1])
                return sbs.cpu(), depth.cpu()

        for _ in range(3):
            frame()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("frame"):
                frame()
            torch.cuda.synchronize()
        path = out_dir / f"trace_{name}.json"
        prof.export_chrome_trace(str(path))
        trace_json = json.loads(path.read_text())
        tr = summarize_trace(trace_json["traceEvents"] if isinstance(trace_json, dict)
                             else trace_json, spans)
        tr["staging"] = staging
        # the host's cost of getting the 4K frame onto the card, untraced
        # (median of 10): the engine's staging (copy into the pinned slot,
        # then a non-blocking H2D enqueue), or a pageable upload, which
        # returns when the copy is done
        up = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if staging == "engine":
                engine._staging.upload(frames[1])
            else:
                torch.from_numpy(frames[1]).to(dev)
            up.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        tr["upload_host_ms"] = statistics.median(up)
        # the host's side of the frame: CPU ops by self time (all threads)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in prof.key_averages()), key=lambda kv: -kv[1])[:8]
        tr["host_top"] = [{"op": k, "self_ms": ms, "calls": n} for k, ms, n in host]
        g = tr["groups"]
        how = ("FrameEngine._dispatch/_finish: pinned upload, program, pinned download"
               if staging == "engine" else
               "harness path, not the engine's: pageable upload, program, .cpu()")
        log(f"[trace] {name} 4K frame ({net_spec.name}; {how}; {card}): span "
            f"{tr['span_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} ms, idle share "
            f"{tr['idle_share']:.3f}; the upload's host ms, untraced, median of 10: "
            f"{tr['upload_host_ms']:.3f}; device ms (kernels) by group: "
            + ", ".join(f"{k} {v['ms']:.3f} ({v['calls']})"
                        for k, v in sorted(g.items(), key=lambda kv: -kv[1]["ms"]))
            + "".join(f"; of which inside {k}: " + (f"{v['ms']:.3f} ms ({v['calls']} kernels, "
                                                     f"{v['ranges']} ranges)" if v else
                                                     "not separable (no GPU-side range "
                                                     "in the trace)")
                      for k, v in tr["spans"].items())
            + "; top kernels: " + "; ".join(f"{k[:60]} {v['ms']:.3f} ({v['calls']})"
                                             for k, v in list(tr["top_kernels"].items())[:8])
            + "; host ops by self CPU ms: " + "; ".join(
                f"{h['op'][:40]} {h['self_ms']:.3f} ({h['calls']})" for h in tr["host_top"]))
        if any(g.get(k, {}).get("calls") != n for k, n in want.items()):
            raise AssertionError(f"trace {name}: kernel instances off, want {want}")
        return tr

    traces = {}
    for name, net, staging in (("flagship", model, "engine"), ("int8", model_q, "engine"),
                               ("flagship_pageable", model, "pageable")):
        want = {"K2 attention": layers, "K1 dibr_pair": 1}
        if name == "int8":
            want["K4 quant_matmul"] = 2 * 4 * layers  # the row pass and the product a call
        traces[name] = trace(name, net, spec, flagship_cfg, staging, want)
    report["trace"] = traces
    del model, model_q
    torch.cuda.empty_cache()

    # -- 16. the port's CLI on the card ----------------------------------------
    report["cli"] = {
        "flagship": cli_flagship(np, counters, layers, card, out_dir),
        "crop": cli_crop(np, torch, counters, layers, card, out_dir),
    }

    # -- 17. VDA flagship: Video-Depth-Anything-Large, 4K Half-SBS ----------
    report["vda"] = vda_phases(np, torch, programs, build_bound, drive, driven, trace, paths,
                               frames, policy, dev, card)

    # -- 20. a real-shape checkpoint on the card, and the CLI with it -------
    report["checkpoint"] = checkpoint_phase(np, torch, build_bound, counters, dev, card, out_dir)

    # -- 21-26. the Depth-Anything-3 family at 504 ----------------------------
    report["da3"] = da3_phases(np, torch, programs, build_bound, drive, driven, trace, paths,
                               frames, counters, policy, dev, card, out_dir)

    # -- 27-29. the remote topology; 30. the control panel ----------------------
    report["remote"] = remote_phases(np, counters, layers, card, out_dir)
    for name in ("xr_raw", "xr_zlib", "xr_zlib_desktop", "xr_mono"):
        r = report["remote"][name]
        log(f"[remote] {name}: engine {r['engine_fps']:.2f} frames/s against the synthetic-source "
            f"flagship's {paths['main']['engine_fps']:.2f} (phase 5) and the CLI's "
            f"{report['cli']['flagship']['timed']['fps']:.2f} (phase 16a) in this call; ingest "
            f"{r['ingest_fps']:.2f} fps; the XR client {r['client']['fps']:.2f} frames/s; {card}")
    report["control"] = control_phase(card, out_dir)

    def entry(name, source, replaces, key, by_path):
        """`launches` sums the runs in `by_path` (path → that run's count,
        each read from its own run with the counts set to 0 before it)."""
        tm = timing[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": float(worst[name]), "ms": tm["kernel"],
                "plain_ms": tm["plain"], "bound_ms": tm["bound"][0],
                "bound_by": tm["bound"][1], "library_ms": tm.get("library")}

    csrc = "desktop2stereo_tpu_torch/csrc/"
    pallas = "desktop2stereo_tpu/ops/pallas/"

    def launches(kernel, *names):
        return {n: paths[n]["launches"][kernel] for n in names}

    def remote_launches(kernel, name):  # a remote CLI run's count, after its warm-up
        return {f"remote_{name}": report["remote"][name]["launches"]["run"][kernel]}

    # each entry's launches: the slice's main path, and the DA3 path's beside it
    kernels = [
        entry("dibr_pair_half", csrc + "dibr_pair.cu", pallas + "dibr.py:535",
              "dibr_pair_half", {**launches("dibr_pair", "main", "da3"),
                                 **remote_launches("dibr_pair", "xr_raw")}),
        entry("dibr_pair_eyes", csrc + "dibr_pair.cu", pallas + "dibr.py:535",
              "dibr_pair_eyes", {**launches("dibr_pair", "generic_high"),
                                 **remote_launches("dibr_pair", "xr_mono")}),
        entry("attention", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention", {**launches("attention", "main", "da3"),
                            **remote_launches("attention", "xr_raw")}),
        entry("warp", csrc + "warp.cu", pallas + "warp.py:93", "warp",
              launches("warp", "generic_fast")),
        entry("dibr_fill", csrc + "dibr_fill.cu", pallas + "dibr.py:709", "dibr_fill",
              {"dibr_render": render_counts["dibr_fill"]}),
        entry("quant_matmul", csrc + "quant_matmul.cu", pallas + "quant_matmul.py:122",
              "quant_matmul_fc1", launches("quant_matmul", "int8", "da3_int8")),
    ]
    report.update(kernels=kernels, timing=timing, frames=FRAMES, paths=paths,
                  reference=refs, model_build_s=model_build_s, int8_build_s=int8_build_s,
                  torch=torch.__version__, cuda=torch.version.cuda)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    log("[device] host packages the sinks and sources import when made: " + ", ".join(
        f"{k} {v}" for k, v in report["host_packages"].items()))
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
