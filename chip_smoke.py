#!/usr/bin/env python3
"""Drive the torch port's flagship frame path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

The flagship path is Depth-Anything-V2-Large (DINOv2 ViT-L/14, seeded random
weights) at depth resolution 518 on a 4K BGRA capture, Half-SBS out:
`build_bound` → `ProgramCache` → `FrameEngine`, through the two hand-written
CUDA kernels of `desktop2stereo_tpu_torch` (attention on all 24 encoder
layers, the both-eyes DIBR pass once per frame).

Phases, each of which raises on failure (non-zero exit, no result line):

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: nvcc builds both kernels from `desktop2stereo_tpu_torch/csrc`;
3. kernel parity on the card against the plain PyTorch versions;
4. kernel times (CUDA events, median of interleaved runs) beside the plain
   versions at the flagship shapes;
5. main path: warmup, then FRAMES synthetic 4K frames through FrameEngine;
   output shape/dtype, finite depth, and launch counts (24 attention
   launches and one DIBR launch per frame) are checked; frames/s and
   per-stage ms are printed;
6. reference: one small frame through the same program on the card (bf16)
   and on the CPU in f32 (plain versions), compared.

The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.  A JSON report with every number also
goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP_MODEL = "Depth-Anything-V2-Large"
FRAME_SHAPE = (2160, 3840, 4)        # 4K BGRA capture; Half-SBS out at 4K
EYE = (FRAME_SHAPE[0], FRAME_SHAPE[1] // 2)
ATTN_SHAPE = (1, 778, 16, 64)        # ViT-L/14 at 294x518: 21*37 + 1 tokens
FRAMES = 40
TIMED_RUNS = 25
SEED = 0

# K1 (u8 output): at most 1 LSB off, on at most 0.1% of the pixels
DIBR_MAX_LSB = 1
DIBR_MAX_SHARE = 1e-3
# K2 (bf16 in/out, f32 accumulation) vs the f32 plain version on unit-normal
# inputs: bf16 output rounding (2^-9 relative) plus bf16 probabilities
ATTN_MAX_ABS = 2e-2
# Whole path, card bf16 vs CPU f32 on one small frame.  bf16 drift through
# 24 layers and the percentile normalisation moves depth by a few hundredths
# and turns into warp shifts at depth edges, so the SBS bound is on the mean
# and on the share of pixels far off, not on the maximum.
REF_DEPTH_MEAN_ABS = 0.03
REF_SBS_MEAN_LSB = 3.0
REF_SBS_SHARE_OVER_32 = 0.03


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def flagship_config(programs):
    """bench.py's flagship settings (Settings defaults otherwise), with the
    model-resolution depth a null sink takes."""
    return programs.ProgramConfig(
        model_name=FLAGSHIP_MODEL, depth_resolution=518, output_height=2160,
        display_mode="Half-SBS", ipd=0.064, depth_strength=2.0, convergence=0.0,
        foreground_scale=0.0, aa_strength=2.0, ema_alpha=0.9,
        temporal_smooth=True, quality="high", emit_depth="model")


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


def time_pair(torch, plain, kernel, runs: int = TIMED_RUNS, reps: int = 10, warm: int = 3):
    """Median ms per call of each callable: CUDA events around `reps`
    back-to-back calls (so the host's launch latency hides behind the device
    work), `runs` samples each, the two callables in alternating turns."""
    for _ in range(warm):
        plain()
        kernel()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for i in range(runs):
        order = (("plain", plain), ("kernel", kernel))
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return statistics.median(times["plain"]), statistics.median(times["kernel"])


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

    def push(self, sbs, depth, stats) -> None:
        import numpy as np

        if sbs.shape != self.shape or sbs.dtype != np.uint8:
            raise AssertionError(f"frame {sbs.dtype} {sbs.shape}, want uint8 {self.shape}")
        if depth is None or not np.isfinite(depth).all():
            raise AssertionError("depth missing or not finite")
        self.count += 1


def main() -> int:
    if not (ROOT / "desktop2stereo_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no desktop2stereo_tpu_torch package beside {__file__}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on an NVIDIA GPU and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.kernels import dibr as K1
    from desktop2stereo_tpu_torch.pipeline import programs
    from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine

    report = {}

    # -- 1. device ---------------------------------------------------------
    policy = cuda_policy(0, allow_tf32=False)
    dev = policy.device
    card = card_line()
    log(card)
    log(f"[device] {policy.name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"compute {policy.compute_dtype}, TF32 matmul/cudnn "
        f"{torch.backends.cuda.matmul.allow_tf32}/{torch.backends.cudnn.allow_tf32}")
    report["card"] = card

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    for k in (K2.KERNEL, K1.KERNEL):
        k.lib  # builds (if the hashed .so is missing) and loads
    build_s = time.perf_counter() - t0
    log(f"[build] attention.cu + dibr_pair.cu built (nvcc "
        + ", ".join(f"{k.source.name} {k.build_seconds:.2f} s" if k.build_seconds is not None
                    else f"{k.source.name} already built" for k in (K2.KERNEL, K1.KERNEL))
        + f") and loaded in {build_s:.2f} s")
    report["build_s"] = build_s

    # -- 3. kernel parity ----------------------------------------------------
    dibr_worst = 0
    for (eh, ew) in (EYE, (50, 200), (96, 256)):
        rng = np.random.default_rng(eh + ew)
        rgb = torch.from_numpy(rng.random((3, eh, ew), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((eh, ew), dtype=np.float32)).to(dev)
        for feather in (0.0, programs.FEATHER_WIDTH):
            for arrangement in ("sbs", "tab"):
                kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01,
                          feather=feather, arrangement=arrangement)
                got = K1.dibr_pair_half(rgb, dep, **kw)
                want = K1.dibr_pair_half_ref(rgb, dep, **kw)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.uint8:
                    raise AssertionError(f"dibr {got.dtype} {tuple(got.shape)} vs {tuple(want.shape)}")
                diff = (got.int() - want.int()).abs()
                lsb = int(diff.max().item())
                share = (diff > 0).float().mean().item()
                dibr_worst = max(dibr_worst, lsb)
                ok = lsb <= DIBR_MAX_LSB and share <= DIBR_MAX_SHARE
                log(f"[parity] dibr eye {eh}x{ew} feather={feather} {arrangement}: "
                    f"max {lsb} LSB (tol {DIBR_MAX_LSB}), differing {share:.2e} "
                    f"(tol {DIBR_MAX_SHARE:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("dibr kernel disagrees with its plain version")

    attn_worst = 0.0
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
        attn_worst = max(attn_worst, err)
        ok = err <= ATTN_MAX_ABS and got.shape == want.shape
        log(f"[parity] attention {list(shape)}{' qkv views' if views else ''} bf16: "
            f"max abs err {err:.3e} (tol {ATTN_MAX_ABS:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("attention kernel disagrees with its plain version")

    # -- 4. kernel times -----------------------------------------------------
    rng = np.random.default_rng(1)
    rgb = torch.from_numpy(rng.random((3, *EYE), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random(EYE, dtype=np.float32)).to(dev)
    dkw = dict(ipd=0.064, depth_strength=2.0, convergence=0.0, feather=0.0, arrangement="sbs")
    dibr_plain_ms, dibr_ms = time_pair(
        torch, lambda: K1.dibr_pair_half_ref(rgb, dep, **dkw),
        lambda: K1.dibr_pair_half(rgb, dep, **dkw))
    B, N, H, D = ATTN_SHAPE
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    attn_plain_ms, attn_ms = time_pair(
        torch, lambda: K2.attention_ref(q, k, v), lambda: K2.attention(q, k, v))
    for name, ms, plain_ms in ((f"dibr eye {EYE[0]}x{EYE[1]} Half-SBS", dibr_ms, dibr_plain_ms),
                               (f"attention {list(ATTN_SHAPE)} bf16 qkv views", attn_ms,
                                attn_plain_ms)):
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call "
            f"(median of {TIMED_RUNS} samples of 10 back-to-back calls; {card})")
    del rgb, dep, qkv, q, k, v

    # -- 5. main path ------------------------------------------------------
    t0 = time.perf_counter()
    model, spec = build_bound(FLAGSHIP_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    model_build_s = time.perf_counter() - t0
    cfg = flagship_config(programs)
    program = programs.ProgramCache(cfg, model, spec, compute_dtype=policy.compute_dtype)
    warm = program.warmup(FRAME_SHAPE)
    log(f"[main] {FLAGSHIP_MODEL} built in {model_build_s:.1f} s; first calls "
        + ", ".join(f"{k} {v:.2f}" for k, v in warm.items()))

    frames = synthetic_frames(np, 4, FRAME_SHAPE[0], FRAME_SHAPE[1], SEED)
    out_shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)  # output height 2160 keeps 4K
    source = SaturatingSource(frames, FRAMES)
    sink = CheckingNullSink(out_shape)
    engine = FrameEngine(source, program, sink, target_fps=0.0)
    source.engine = engine
    K2.KERNEL.launches = 0
    K1.KERNEL.launches = 0
    t0 = time.perf_counter()
    stats = engine.run(duration=600.0)
    wall_s = time.perf_counter() - t0
    n_attn, n_dibr = K2.KERNEL.launches, K1.KERNEL.launches
    layers = len(model.backbone.layer)  # 24 for ViT-L
    log(f"[main] {engine.frames} frames, {sink.count} delivered, {engine.dropped} dropped; "
        f"launches: attention {n_attn} (want {layers}x{FRAMES}), dibr {n_dibr} (want {FRAMES})")
    # the source waits for the engine, so no input frame is dropped; the
    # sink side stays latest-wins, so a delivered frame may be superseded
    if engine.frames != FRAMES or sink.count + engine.out_box.dropped != FRAMES:
        raise AssertionError(f"{engine.frames} frames run, {sink.count} delivered, "
                             f"{engine.out_box.dropped} superseded; want {FRAMES} run")
    if n_attn != layers * FRAMES or n_dibr != FRAMES:
        raise AssertionError("a kernel of the path was not launched once per layer/frame")
    engine_fps = FRAMES / wall_s

    # per-stage device time, the three stage seams timed with CUDA events
    p = program.program
    state = programs.init_state(*programs.ema_shape(cfg, spec, *FRAME_SHAPE[:2]), device=dev)
    stage_ms = {"pre": [], "model": [], "tail": [], "step": []}
    with torch.inference_mode():
        frame_dev = torch.from_numpy(frames[0]).to(dev)
        for i in range(TIMED_RUNS + 3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            rgb_h, model_in = p.preprocess(frame_dev)
            ev[1].record()
            raw = p.model_stage(model_in)
            ev[2].record()
            sbs, _, small = p.post_stereo_stage(raw, state.ema_depth, rgb_h)
            ev[3].record()
            ev[3].synchronize()
            state = programs.FrameState(ema_depth=small)
            if i >= 3:
                for name, a, b in (("pre", 0, 1), ("model", 1, 2), ("tail", 2, 3), ("step", 0, 3)):
                    stage_ms[name].append(ev[a].elapsed_time(ev[b]))
    stage_med = {k: statistics.median(v) for k, v in stage_ms.items()}
    log(f"[main] engine {engine_fps:.2f} frames/s over {FRAMES} frames "
        f"(fps counter {stats.fps:.2f}); stage ms pre {stage_med['pre']:.3f}, "
        f"model {stage_med['model']:.3f}, tail {stage_med['tail']:.3f}, "
        f"step {stage_med['step']:.3f} (CUDA events at the stage seams, host launch "
        f"gaps included, median of {TIMED_RUNS}); {card}")
    if tuple(sbs.shape) != out_shape or sbs.dtype != torch.uint8:
        raise AssertionError(f"step output {sbs.dtype} {tuple(sbs.shape)}")

    # -- 6. reference on a small frame: card bf16 vs CPU f32 ----------------
    small_frame = synthetic_frames(np, 1, 216, 384, SEED + 1)[0]
    card_prog = programs.ProgramCache(cfg, model, spec, compute_dtype=policy.compute_dtype)
    sbs_c, depth_c = (t.cpu() for t in card_prog(small_frame))
    del model, program, card_prog
    torch.cuda.empty_cache()
    cpu_model, _ = build_bound(FLAGSHIP_MODEL, device="cpu", dtype=torch.float32, seed=SEED)
    t0 = time.perf_counter()
    sbs_r, depth_r = programs.ProgramCache(cfg, cpu_model, spec, compute_dtype=torch.float32)(small_frame)
    cpu_s = time.perf_counter() - t0
    if not torch.isfinite(depth_c).all() or sbs_c.shape != sbs_r.shape:
        raise AssertionError("reference frame: non-finite depth or shape mismatch")
    d_err = (depth_c - depth_r).abs()
    s_err = (sbs_c.int() - sbs_r.int()).abs().float()
    ref = {"depth_mean_abs": d_err.mean().item(), "depth_max_abs": d_err.max().item(),
           "sbs_mean_lsb": s_err.mean().item(), "sbs_max_lsb": s_err.max().item(),
           "sbs_share_over_32": (s_err > 32).float().mean().item(), "cpu_s": cpu_s}
    ok = (ref["depth_mean_abs"] <= REF_DEPTH_MEAN_ABS and ref["sbs_mean_lsb"] <= REF_SBS_MEAN_LSB
          and ref["sbs_share_over_32"] <= REF_SBS_SHARE_OVER_32)
    log(f"[reference] 216x384 frame, card bf16 vs CPU f32: depth mean {ref['depth_mean_abs']:.4f} "
        f"(tol {REF_DEPTH_MEAN_ABS}) max {ref['depth_max_abs']:.4f}; sbs mean "
        f"{ref['sbs_mean_lsb']:.3f} LSB (tol {REF_SBS_MEAN_LSB}) max {ref['sbs_max_lsb']:.0f}, "
        f">32 LSB {ref['sbs_share_over_32']:.2e} (tol {REF_SBS_SHARE_OVER_32}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's output disagrees with the CPU f32 reference")

    kernels = [
        {"name": "attention", "route": "cuda",
         "source": "desktop2stereo_tpu_torch/csrc/attention.cu",
         "replaces": "desktop2stereo_tpu/ops/pallas/flash_attention.py:79",
         "launches": n_attn, "max_abs_err": attn_worst, "ms": attn_ms,
         "plain_ms": attn_plain_ms},
        {"name": "dibr_pair_half", "route": "cuda",
         "source": "desktop2stereo_tpu_torch/csrc/dibr_pair.cu",
         "replaces": "desktop2stereo_tpu/ops/pallas/dibr.py:535",
         "launches": n_dibr, "max_abs_err": float(dibr_worst), "ms": dibr_ms,
         "plain_ms": dibr_plain_ms},
    ]
    report.update(kernels=kernels, frames=FRAMES, engine_fps=engine_fps,
                  fps_counter=stats.fps, stage_ms=stage_med, warmup_s=warm,
                  model_build_s=model_build_s, reference=ref,
                  torch=torch.__version__, cuda=torch.version.cuda)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
