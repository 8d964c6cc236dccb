"""Command-line runner: the reference's `main.py` orchestrator as a CLI, on
the torch port.

    python -m desktop2stereo_tpu_torch.cli --source synthetic --sink null --frames 30
    python -m desktop2stereo_tpu_torch.cli --device cpu --source synthetic \\
        --size 64x112 --frames 2 --sink null --model Depth-Anything-V2-Small --depth-res 56
    python -m desktop2stereo_tpu_torch.cli --source tcp:7800 --sink xr,mjpeg

Port of `desktop2stereo_tpu/cli.py`, with its flags and behaviour: settings
defaults from a reference settings.yaml, the sink-negotiated depth output,
the window sink's fill-16:9 rule, the letterbox crop, SIGINT/SIGTERM and a
`stop.request` file channel, a hard-exit watchdog, stats lines, and the shape
probe run as frame 0.

`--device cuda` (the default; `auto` is an alias) runs on CUDA device 0 and
exits non-zero without one: there is no CPU fallback.  `--device cpu` runs
the plain-PyTorch versions of the kernels, for tests and small runs.
`--fp32` computes in float32 on the card; `--quant int8` builds the int8
encoder.  `--checkpoint` loads safetensors weights (one file, an index json
or one shard of a sharded set); without it the model factory looks in its
local caches (`models/factory.py:find_checkpoint`) and otherwise draws
seeded random weights.  `--model Video-Depth-Anything-*` streams, its
temporal window carried from frame to frame; `--model DA3-*` runs the
Depth-Anything-3 family (`--quant int8` exits naming the refusal for
DA3NESTED-GIANT-LARGE, as the JAX CLI's factory refuses it).

The remote topology: `--source tcp[:PORT]` listens for a capture agent
(`python -m desktop2stereo_tpu_torch.tools.capture_agent --connect
HOST:PORT` on the desktop; the shared secret `D2S_INGEST_TOKEN` on both
ends), `--sink xr` serves the frame and its model-resolution depth to XR
clients on `--port` (1123 by default; 0 binds a free port), and `--sink
rtmp` publishes through ffmpeg.

`--streams N` serves N feeds through one program with per-stream state
(`pipeline/multi.py`): N sources of the `--source` kind (synthetic with
seed i, `<ring>_i` shm rings, the same image or video) into N sinks of the
`--sink` kind (png into `<out>_i`, video into `<root>_i<ext>`, mjpeg on
`port + i`, null), round-robin; with `--batched`, one batch of every
stream's newest frame a launch (the frames must share one shape, and
`--crop` is refused).  `--profile-dir DIR` writes a torch.profiler Chrome
trace of the run after the warm-up into DIR, taken on the engine's compute
thread, and beside it the engine's span log as JSON (`<trace>.spans.json`:
every span, each frame's latency in parts, and the offset that places the
spans on the trace).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import signal
import sys
import threading
import time

DEVICES = ("cuda", "cpu", "auto")
TRACE_WRITE_S = 300.0  # bound on the compute thread's writing of a --profile-dir trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="d2s-torch", description="2D→3D stereo pipeline on one NVIDIA GPU (torch port)")
    p.add_argument("--settings", help="settings.yaml (reference-compatible)")
    p.add_argument("--model", help="model name from the registry")
    p.add_argument("--source", default=None,
                   help="synthetic|image|video|screen|shm|tcp[:PORT]. "
                        "tcp listens for a remote capture agent "
                        "(tools.capture_agent --connect HOST:PORT). "
                        "default: screen when --settings is given (the "
                        "reference app's behavior), else synthetic")
    p.add_argument("--input", help="path for image/video sources, ring name for shm")
    p.add_argument("--window-title",
                   help="screen source: capture the window whose title "
                        "contains this substring (tracked on move/resize)")
    p.add_argument("--no-cursor", action="store_true",
                   help="screen source: do not composite the mouse cursor")
    p.add_argument("--monitor", type=int, default=None,
                   help="screen source: capture this monitor index "
                        "(0 = primary/whole root)")
    p.add_argument("--audio", default="auto",
                   help="rtmp sink: 'auto' (system audio if present), "
                        "'none', or an explicit pulse device name")
    p.add_argument("--sink", default=None,
                   help="one of mjpeg|png|video|null|rtmp|viewer|window|xr, "
                        "or a comma list to tee (e.g. xr,mjpeg). default: "
                        "derived from the settings 'Run Mode' when "
                        "--settings is given, else mjpeg")
    p.add_argument("--show-fps", action="store_true",
                   help="green FPS overlay on the output (mjpeg/viewer sinks)")
    p.add_argument("--feather", action="store_true",
                   help="per-eye edge feathering (the reference viewer's "
                        "KEY_B effect; toggle live with 'b' in the window "
                        "sink or GET /feather on the MJPEG sink)")
    p.add_argument("--out", help="output path/dir for png/video sinks, URL for rtmp")
    p.add_argument("--frames", type=int, help="stop after N frames")
    p.add_argument("--duration", type=float, help="stop after N seconds")
    p.add_argument("--fps", type=float, help="capture pacing FPS")
    p.add_argument("--size", default="1080x1920", help="synthetic source HxW")
    p.add_argument("--depth-res", type=int, help="model input resolution")
    p.add_argument("--display-mode", help="Half-SBS/Full-SBS/.../Depth")
    p.add_argument("--port", type=int, help="MJPEG port (xr: its port, 0 a free one)")
    p.add_argument("--xr-no-input", action="store_true",
                   help="xr sink: refuse OS-input injection from headset "
                        "clients (view-only host)")
    p.add_argument("--quality", default="high", choices=["high", "fast"],
                   help="stereo path: DIBR+inpaint vs grid-shift")
    p.add_argument("--checkpoint", help="safetensors weights: a file, an index json or one "
                                        "shard (default: the local caches, else seeded "
                                        "random weights)")
    p.add_argument("--fp32", action="store_true", help="float32 compute instead of bf16")
    p.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="'cuda' (default; 'auto' is an alias): CUDA device 0, "
                        "no CPU fallback; 'cpu': the plain-PyTorch kernel "
                        "versions on the CPU")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 encoder matmuls (the fused int8 dense kernel)")
    p.add_argument("--crop", default=None,
                   help="letterbox handling: off | auto (detected with "
                        "hysteresis) | u0,v0,uw,vh manual UV rect "
                        "(default: the settings 'Crop Mode', else off)")
    p.add_argument("--stop-file", default="logs/stop.request",
                   help="touch this file to request shutdown")
    p.add_argument("--stats-every", type=float, default=2.0,
                   help="seconds between stats lines (0 = quiet)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run (Chrome trace "
                        "JSON, CPU and CUDA activity) into this dir, and the "
                        "engine's span log beside it; starts after the "
                        "warm-up so kernel builds stay out of it")
    p.add_argument("--streams", type=int, default=1,
                   help="serve N concurrent feeds through one pipeline "
                        "(per-stream state; png/video/mjpeg sinks get "
                        "per-stream suffixes)")
    p.add_argument("--batched", action="store_true",
                   help="with --streams N: stack the streams into one "
                        "device batch per launch")
    return p


def _sink_for_run_mode(run_mode: str) -> str:
    """The settings 'Run Mode' → sink mapping (reference utils.py:1046-1064
    derives RUN_MODE/STREAM_MODE the same way; presentation is a window
    when a display exists, else the browser viewer)."""
    rm = (run_mode or "").strip()
    if rm in ("Local Viewer", "3D Monitor", "Viewer"):
        return "window" if os.environ.get("DISPLAY") else "viewer"
    if rm == "RTMP Streamer":
        return "rtmp"
    if rm in ("OpenXR Link", "OpenXR"):
        return "xr"
    # "MJPEG Streamer" and the legacy "Streamer" torch-compositor mode
    return "mjpeg"


def apply_settings_defaults(args, settings) -> None:
    """Fill CLI flags the user left unset from a reference-style
    settings.yaml: the reference app is driven entirely by settings
    (capture mode/window/monitor, run mode, crop; reference utils.py:840,
    853-854, 1046-1073), so `--settings file.yaml` alone reproduces a
    reference run.  Explicit flags always win; without --settings the
    historical CLI defaults apply."""
    had = bool(args.settings)
    extra = settings.extra if had else {}
    if args.source is None:
        args.source = "screen" if had else "synthetic"
        args.source_from_settings = had
    # reject typos now, before device detection and the model build
    if args.source.split(":", 1)[0] not in (
            "screen", "synthetic", "shm", "image", "video", "tcp"):
        raise SystemExit(
            f"unknown --source {args.source!r} (valid: screen, synthetic, "
            f"shm, image, video, tcp[:<port>])")
    if args.sink is None:
        args.sink = _sink_for_run_mode(settings.run_mode) if had else "mjpeg"
        # the reference's flat preview alongside XR (utils.py:1072)
        if args.sink == "xr" and extra.get("XR Preview"):
            args.sink = "xr,mjpeg"
    if args.crop is None:
        mode = str(extra.get("Crop Mode", "")).strip().lower()
        args.crop = "auto" if mode == "auto" else "off"
    if args.monitor is None:
        mi = extra.get("Monitor Index")
        args.monitor = int(mi) if isinstance(mi, int) and not isinstance(mi, bool) else 0
    if args.window_title is None and str(extra.get("Capture Mode", "")).strip() == "Window":
        title = str(extra.get("Window Title") or "").strip()
        if title:
            args.window_title = title


def device_policy(device: str, fp32: bool):
    """(torch device, compute dtype) for `--device`; exits 2 naming the
    cause when CUDA is asked for and absent (no CPU fallback)."""
    import torch

    from desktop2stereo_tpu_torch.core.runtime import cuda_policy

    if device == "cpu":
        return torch.device("cpu"), torch.float32
    try:
        policy = cuda_policy(0)
    except RuntimeError as e:
        print(f"[d2s] FATAL: {e}. Run on a CUDA card, or pass --device cpu for the "
              f"plain-PyTorch path.", file=sys.stderr)
        raise SystemExit(2)
    return policy.device, torch.float32 if fp32 else policy.compute_dtype


def make_components(args, settings):
    from desktop2stereo_tpu_torch.core.registry import effective_compute_dtype, get_spec
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.pipeline.programs import (
        BatchedProgramCache, ProgramCache, ProgramConfig)
    from desktop2stereo_tpu_torch.sinks import SINK_KINDS, make_sink
    from desktop2stereo_tpu_torch.sources import make_source

    device, dtype = device_policy(args.device, args.fp32)
    compute_dtype = effective_compute_dtype(get_spec(settings.model), dtype)
    print(f"[d2s] device: {device}, compute dtype: {compute_dtype}")
    model, spec = build_bound(settings.model, device=device, dtype=compute_dtype,
                              quant=args.quant, checkpoint=args.checkpoint)

    cfg = ProgramConfig.from_settings(settings, quality=args.quality)
    kinds = [k.strip() for k in args.sink.split(",") if k.strip()]
    # Sink-negotiated depth output: png saves full-res depth images; every
    # other sink takes the model-resolution depth or none
    if "png" not in kinds:
        cfg = dataclasses.replace(cfg, emit_depth="model")
    if args.feather:
        cfg = dataclasses.replace(cfg, edge_feather=True)
    if settings.fill_16_9 and "window" in args.sink:
        # the window sink pads to 16:9 at presentation time (the reference
        # viewer's viewport fit, viewer.py:1760-1770, live 'a' key); padding
        # in the device program too would pad twice
        cfg = dataclasses.replace(cfg, fill_16_9=False)
    if args.streams > 1 and args.batched:
        if args.crop and args.crop != "off":
            raise SystemExit("--batched does not support --crop")
        program = BatchedProgramCache(cfg, model, spec, compute_dtype=compute_dtype,
                                      num_streams=args.streams)
    else:
        program = ProgramCache(cfg, model, spec, compute_dtype=compute_dtype)

    if args.crop and args.crop != "off":
        # letterbox crop between capture and the frame program (reference
        # xr_viewer/crop.py), per stream, on the frame's device
        from desktop2stereo_tpu_torch.pipeline.crop import CropProgram

        rect = None
        if args.crop != "auto":
            rect = tuple(float(v) for v in args.crop.split(","))
            if len(rect) != 4:
                raise SystemExit("--crop expects 'auto' or u0,v0,uw,vh")
        program = CropProgram(program, rect)

    src_kw = {}
    if args.source == "synthetic":
        h, w = (int(v) for v in args.size.split("x"))
        src_kw = {"size": (h, w)}
    elif args.source == "screen":
        src_kw = {"window_title": args.window_title,
                  "with_cursor": not args.no_cursor,
                  "monitor_index": args.monitor}
    elif args.source == "shm":
        src_kw = {"name": args.input or "/d2s_frames"}
    elif args.source.split(":", 1)[0] == "tcp":
        # network frame ingest from a remote desktop's capture agent; the
        # optional shared secret rides D2S_INGEST_TOKEN
        port = 7800
        if ":" in args.source:
            try:
                port = int(args.source.split(":", 1)[1])
            except ValueError:
                port = -1
            if not 0 <= port <= 65535:
                raise SystemExit(f"--source {args.source!r}: expected tcp:<port 0-65535> "
                                 f"(e.g. tcp:7800)")
        # timeout None: a server waits for its agent indefinitely (agents
        # restart, links drop for more than 30 s), unless the run is bounded
        src_kw = {"port": port, "timeout": 30.0 if args.frames else None,
                  "token": os.environ.get("D2S_INGEST_TOKEN")}
    elif args.source in ("image", "video"):
        if not args.input:
            raise SystemExit(f"--source {args.source} requires --input")
        src_kw = {"path": args.input}
        if args.source == "video":
            src_kw["loop"] = args.frames is not None
    if args.frames:
        src_kw["max_frames"] = args.frames
    try:
        source = make_source(args.source.split(":", 1)[0], **src_kw)
    except Exception as e:
        if args.source == "screen" and getattr(args, "source_from_settings", False):
            # the screen default came from --settings, not the user's hand;
            # a headless host falls back instead of dying
            print(f"[d2s] screen capture unavailable ({e}); using the synthetic source")
            h, w = (int(v) for v in args.size.split("x"))
            src_kw = {"size": (h, w)}
            if args.frames:
                src_kw["max_frames"] = args.frames
            args.source = "synthetic"
            source = make_source("synthetic", **src_kw)
        else:
            raise

    unknown = [k for k in kinds if k not in SINK_KINDS]
    if unknown or not kinds:
        raise SystemExit(
            f"unknown sink {unknown or args.sink!r}; choose from "
            + "|".join(SINK_KINDS) + " (comma list to tee)")
    # --port steers only the first sink of a tee; the rest keep their
    # defaults (two sinks on one port would collide at bind time)
    rest = copy.copy(args)
    rest.port = None
    sinks = [make_sink(k, **_sink_kwargs(k, args if i == 0 else rest, settings))
             for i, k in enumerate(kinds)]
    if len(sinks) == 1:
        sink = sinks[0]
    else:
        from desktop2stereo_tpu_torch.sinks.tee import TeeSink

        sink = TeeSink(sinks)
    return source, program, sink, settings


def _sink_kwargs(kind: str, args, settings) -> dict:
    if kind == "png":
        return {"out_dir": args.out or "out", "save_depth": True}
    if kind == "video":
        return {"path": args.out or "out.mp4", "fps": settings.fps}
    if kind == "mjpeg":
        return {"port": args.port or settings.streamer_port,
                "fps": settings.fps, "quality": settings.stream_quality,
                "show_fps": args.show_fps or settings.show_fps}
    if kind == "viewer":
        return {"port": args.port or settings.streamer_port,
                "fps": settings.fps,
                "show_fps": args.show_fps or settings.show_fps}
    if kind == "window":
        return {"keep_aspect": bool(settings.extra.get("Fix Viewer Aspect", False)),
                "fill_16_9": settings.fill_16_9}
    if kind == "rtmp":
        # no --out: publish to a local mediamtx sidecar at the settings
        # 'Stream Key' path (reference main.py:754, 987, 993-1017); CRF and
        # Audio Delay ride the settings file too (main.py:522, 535)
        key = str(settings.extra.get("Stream Key") or "live")
        return {"url": args.out or f"rtmp://127.0.0.1:1935/{key}", "serve": not args.out,
                "fps": settings.fps, "audio": args.audio,
                "crf": int(settings.extra.get("CRF") or 20),
                "audio_delay": float(settings.extra.get("Audio Delay") or 0.0)}
    if kind == "xr":
        # the settings-derived session config, so clients at default flags
        # render with the file's stereo parameters
        return {"port": 1123 if args.port is None else args.port,
                "inject_input": not args.xr_no_input,
                "meta": {"ipd": settings.ipd, "depth_strength": settings.depth_strength,
                         "convergence": settings.convergence,
                         "display_mode": settings.display_mode,
                         "foreground_scale": settings.foreground_scale,
                         "environment": settings.extra.get("Environment Model"),
                         "controller": settings.extra.get("Controller Model")}}
    return {}


def run(args=None) -> int:
    args = build_parser().parse_args(args)
    if args.device == "auto":
        args.device = "cuda"

    # Clear any stale stop.request from a previous session first, before
    # the model build, so a stop requested during it is honoured while a
    # leftover from a killed earlier run cannot abort this one.
    if args.stop_file and os.path.exists(args.stop_file):
        try:
            os.remove(args.stop_file)
            print("[d2s] cleared stale stop.request from a previous run")
        except OSError:
            pass

    from desktop2stereo_tpu_torch.core.config import Settings, load_settings
    from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
    from desktop2stereo_tpu_torch.pipeline.profiling import TraceRequest

    settings = load_settings(args.settings) if args.settings else Settings()
    overrides = {}
    if args.model:
        overrides["model"] = args.model
    if args.depth_res:
        overrides["depth_resolution"] = args.depth_res
    if args.display_mode:
        overrides["display_mode"] = args.display_mode
    if args.fps:
        overrides["fps"] = args.fps
    if overrides:
        settings = settings.replace(**overrides)

    apply_settings_defaults(args, settings)
    try:
        source, program, sink, settings = make_components(args, settings)
    except (KeyError, ValueError, FileNotFoundError, NotImplementedError) as e:
        # unknown model or mode, an unported kind, a checkpoint that is not
        # there, a quant mode the model refuses (DA3NESTED)
        raise SystemExit(f"[d2s] {e}")

    if args.streams > 1:
        return _run_multi(args, settings, source, program, sink)

    shutdown = threading.Event()

    def handle(sig, frame):
        print(f"[d2s] signal {sig}; shutting down")
        shutdown.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, handle)
        except (ValueError, OSError):
            pass  # not the main thread (tests)

    # stop.request file channel (reference main.py:343-357)
    def stop_file_watcher():
        while not shutdown.is_set():
            if args.stop_file and os.path.exists(args.stop_file):
                try:
                    os.remove(args.stop_file)
                except OSError:
                    pass
                print("[d2s] stop.request received")
                shutdown.set()
                return
            time.sleep(0.5)

    threading.Thread(target=stop_file_watcher, daemon=True).start()

    engine = FrameEngine(source, program, sink, target_fps=settings.fps, shutdown=shutdown)

    mode_target = getattr(program, "base", program)
    if hasattr(sink, "mode_switcher") and hasattr(mode_target, "set_display_mode"):
        sink.mode_switcher = mode_target  # live display-mode hot keys

    if getattr(sink, "url", None):
        print(f"[d2s] streaming at {sink.url}")

    # Warm up for the source's frame shape (reference warmup_model x3); the
    # probe is then frame 0, staged like every other frame
    probe = source.grab()
    if probe is not None:
        _warm_line(program, probe.shape)
        engine.preload(probe)
    if args.profile_dir:
        engine.trace = TraceRequest(args.profile_dir)

    try:
        engine.start()
        t_end = None if args.duration is None else time.monotonic() + args.duration
        last_stats = time.monotonic()
        while not shutdown.is_set():
            now = time.monotonic()
            if t_end is not None and now >= t_end:
                break
            if args.frames is not None and engine.frames >= args.frames:
                break
            if engine.drained():
                break  # finite source exhausted and all frames processed
            if args.stats_every and now - last_stats >= args.stats_every:
                s = engine.stats()
                lat = ", ".join(f"{k}={v * 1000:.1f}ms" for k, v in s["latency"].items())
                net = ""
                if hasattr(source, "stats"):  # the tcp ingest's fps and drops
                    ns = source.stats()
                    net = (f" ingest={ns['ingest_fps']:.1f}fps "
                           f"net_dropped={ns['frames_dropped']}")
                print(f"[d2s] fps={s['fps']:.1f} (1%low={s['fps_1pct_low']:.1f}) "
                      f"dropped={s['dropped']} {lat}{net}")
                last_stats = now
            time.sleep(0.05)
    finally:
        if engine.trace is not None:
            _write_trace(engine)
        shutdown.set()
        # watchdog: hard-exit if native threads refuse to unwind
        # (reference main.py:325-339)
        watchdog = threading.Timer(8.0, lambda: os._exit(1))
        watchdog.daemon = True
        watchdog.start()
        try:
            try:
                engine.stop()
            except Exception as e:
                # a user quit from the window sink is a normal shutdown
                from desktop2stereo_tpu_torch.sinks.window import WindowCloseRequested

                if not isinstance(e, WindowCloseRequested):
                    raise
                print("[d2s] window closed")
        finally:
            for obj in (sink, source):
                try:
                    getattr(obj, "shutdown", obj.close)()
                except Exception:
                    pass
            watchdog.cancel()

    final = engine.stats_final()
    print(f"[d2s] done: {final.frames} frames ({final.dropped} dropped), "
          f"avg {final.fps:.1f} FPS, 1% low {final.fps_1pct_low:.1f}")
    return 0


def _write_trace(engine) -> None:
    """Wait for the engine's profiler trace, then write its span log beside
    it (the per-frame split, with the offset that places each span on the
    trace); print both paths."""
    from desktop2stereo_tpu_torch.pipeline.profiling import export_spans

    path = engine.trace.finish(TRACE_WRITE_S)
    print(f"[d2s] profiler trace -> {path}")
    if path is not None:
        print(f"[d2s] span log -> {export_spans(engine.spans, path)}")


def _warm_line(program, shape) -> None:
    t0 = time.perf_counter()
    print(f"[d2s] warming up for frame shape {shape} ...")
    rep = program.warmup(shape)
    detail = ("  (" + ", ".join(f"{k[:-2]} {v:.2f}s" for k, v in rep.items())
              + ")") if rep else ""
    print(f"[d2s] warm in {time.perf_counter() - t0:.1f}s{detail}")


def _run_multi(args, settings, source0, program, sink0) -> int:
    """--streams N: N sources → MultiStreamEngine (or, with --batched,
    BatchedStreamEngine) → N sinks, one program with per-stream carried
    state (JAX `cli.py:596-683`)."""
    from desktop2stereo_tpu_torch.pipeline import multi
    from desktop2stereo_tpu_torch.pipeline.profiling import TraceRequest
    from desktop2stereo_tpu_torch.sinks import make_sink
    from desktop2stereo_tpu_torch.sources import make_source

    n = args.streams
    sources, sinks = [source0], [sink0]
    try:
        for i in range(1, n):
            kw = {"max_frames": args.frames} if args.frames else {}
            if args.source == "synthetic":
                h, w = (int(v) for v in args.size.split("x"))
                sources.append(make_source("synthetic", size=(h, w), seed=i, **kw))
            elif args.source == "shm":
                sources.append(make_source("shm", name=f"{args.input or '/d2s_frames'}_{i}",
                                           **kw))
            elif args.source in ("image", "video"):
                if args.source == "video":
                    kw["loop"] = args.frames is not None
                sources.append(make_source(args.source, path=args.input, **kw))
            else:
                raise SystemExit(f"--streams with --source {args.source} unsupported")

            if args.sink == "png":
                sinks.append(make_sink("png", out_dir=f"{args.out or 'out'}_{i}",
                                       save_depth=True))
            elif args.sink == "video":
                # splitext, not rpartition: a dotted directory name is not the
                # extension ("results.v2/capture")
                root, ext = os.path.splitext(args.out or "out.mp4")
                sinks.append(make_sink("video", path=f"{root}_{i}{ext}", fps=settings.fps))
            elif args.sink == "mjpeg":
                sinks.append(make_sink("mjpeg", port=(args.port or settings.streamer_port) + i,
                                       fps=settings.fps, quality=settings.stream_quality,
                                       show_fps=args.show_fps or settings.show_fps))
            elif args.sink == "null":
                sinks.append(make_sink("null"))
            else:
                raise SystemExit(f"--streams with --sink {args.sink} unsupported")

        shutdown = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, lambda *_a: shutdown.set())
            except (ValueError, OSError):
                pass  # not the main thread (tests)

        probe = sources[0].grab()
        if probe is not None:
            _warm_line(program, probe.shape)
        engine_cls = multi.BatchedStreamEngine if args.batched else multi.MultiStreamEngine
        engine = engine_cls(sources, program, sinks, target_fps=settings.fps,
                            shutdown=shutdown)
        if probe is not None:
            engine.preload(probe, stream=0)  # stream 0's first frame, not a casualty
        if args.profile_dir:
            engine.trace = TraceRequest(args.profile_dir)
        stats = engine.run(duration=args.duration)
        if engine.trace is not None:
            # the compute thread writes it as it leaves, maybe after run()
            _write_trace(engine)
    finally:
        for obj in sources + sinks:
            try:
                getattr(obj, "shutdown", obj.close)()
            except Exception:
                pass
    for name, s in stats.items():
        print(f"[d2s] {name}: {s['frames']} frames ({s['dropped']} dropped), "
              f"{s.get('fps', 0.0):.1f} FPS")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
