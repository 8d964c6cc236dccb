"""The frame path: preprocess → model → depth post + EMA → stereo tail.

Port of `desktop2stereo_tpu/pipeline/programs.py` (`_build_step` and
`ProgramCache`).  Two tails, chosen per frame as the JAX package chooses:

- the fused tail, for high quality Half-SBS / Half-TAB with no 16:9 fill
  and an even halved axis:
  `preprocess` builds the planar f32 frame and pair-mean squeezes it to the
  eye buffer [3, eh, ew]; `post_stereo_stage` runs depth post + EMA at model
  resolution, resizes depth to eye size, and the DIBR kernel K1 writes the
  finished u8 HWC frame;
- the generic tail, for everything else: `preprocess` keeps the HWC frame
  [oh, ow, 3] in the compute dtype; `post_stage` runs depth post + EMA,
  `stereo_stage` upsamples depth to output size and `ops/stereo.py`
  composes the display mode (K1 eyes mode at high quality, the warp kernel
  K3 at fast quality), then the u8 cast.

Each stage is its own method so that it can be timed on its own.  PyTorch
runs them eagerly; there is no jit analog.  `ProgramCache` carries the state
per (stream, output size): the EMA, and a stateful model's carry (VDA's
temporal window).  `BatchedProgramCache` (JAX `programs.py:612-671`) runs S
streams as one batch: a `FrameProgram` with a stream axis takes [S, ...]
through every stage, as `jax.vmap` gives the JAX stages one (the model at
batch S, the depth post and EMA row by row, one K1 launch over the stream
axis on the fused tail and on the generic tail's high quality), and carries
the state per (S, output size).  A stateful model has `first(pixels) → (raw, carry)` and
`step(pixels, carry) → (raw, carry')`; the model stage runs `first` on an
empty carry (a new stream or output size) and `step` after it, as the JAX
package's first and step programs do.  A stateless model runs `forward` and
carries `()`.  Display mode, depth strength and edge feather switch live, at
the start of the next frame, and every carry survives the switch.

While a profiler records the thread that runs the frames, the model stage
also opens a `d2s.model/<module>` range around each of the model's child
modules (`profiling.ModuleRanges`); otherwise no hook is installed.  The
warm-up records `d2s.setup.warmup` and its stages' first calls in the
process-wide span log.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES, Settings
from desktop2stereo_tpu_torch.core.registry import ModelSpec, get_spec
from desktop2stereo_tpu_torch.core.runtime import cuda_policy
from desktop2stereo_tpu_torch.ops.depth_post import ema, post_process_depth
from desktop2stereo_tpu_torch.ops.kernels.dibr import dibr_pair_half, quantize_u8
from desktop2stereo_tpu_torch.ops.normalize import (
    bgra_to_rgb, normalize_for_model, process_frame_size)
from desktop2stereo_tpu_torch.ops.resize import (
    patch_aligned_size, resize, resize_halved)
from desktop2stereo_tpu_torch.ops.stereo import (
    FEATHER_WIDTH, stereo_compose, stereo_compose_streams)
from desktop2stereo_tpu_torch.pipeline.profiling import PROCESS_LOG, ModuleRanges, annotate

HALF_MODES = ("Half-SBS", "Half-TAB")
QUALITIES = ("high", "fast")


class FrameState(NamedTuple):
    """Carried state: the EMA depth at model resolution (NaN before frame 1)
    and the model's carry (`()` before frame 1, and always for a stateless
    model)."""

    ema_depth: torch.Tensor  # [mh, mw] float32, [S, mh, mw] with a stream axis
    model: Tuple = ()


def init_state(height: int, width: int,
               device: Optional[torch.device | str] = None, streams: int = 0) -> FrameState:
    """The state before frame 1 on `device`; None is the CUDA device policy's
    (`cuda_policy()`, which raises without CUDA).  `streams` S > 0 stacks S
    such states on a leading stream axis."""
    if device is None:
        device = cuda_policy().device
    shape = (streams, height, width) if streams else (height, width)
    return FrameState(ema_depth=torch.full(shape, float("nan"), dtype=torch.float32,
                                           device=device))


@dataclass(frozen=True)
class ProgramConfig:
    """Static settings of one frame program (fields as in the JAX package)."""

    model_name: str
    depth_resolution: int
    output_height: int
    display_mode: str
    ipd: float
    depth_strength: float
    convergence: float
    foreground_scale: float
    aa_strength: float
    ema_alpha: float
    temporal_smooth: bool
    quality: str  # "high": DIBR + inpaint; "fast": the grid-shift compositor
    edge_feather: bool = False
    fill_16_9: bool = False
    emit_depth: str = "full"  # "full": depth at output res; "model": model res

    @classmethod
    def from_settings(cls, s: Settings, quality: str = "high") -> "ProgramConfig":
        return cls(
            model_name=s.model,
            depth_resolution=s.depth_resolution,
            output_height=s.output_resolution,
            display_mode=s.display_mode,
            ipd=s.ipd,
            depth_strength=s.depth_strength,
            convergence=s.convergence,
            foreground_scale=s.foreground_scale,
            aa_strength=s.aa_strength,
            ema_alpha=s.ema_alpha,
            temporal_smooth=s.temporal_smooth,
            quality=quality,
            fill_16_9=s.fill_16_9,
        )


def check_supported(cfg: ProgramConfig) -> None:
    """Raise ValueError for a setting outside the known values."""
    if cfg.display_mode not in DISPLAY_MODES:
        raise ValueError(f"unknown display mode {cfg.display_mode!r}; one of {DISPLAY_MODES}")
    if cfg.quality not in QUALITIES:
        raise ValueError(f"quality must be one of {QUALITIES}, got {cfg.quality!r}")
    if cfg.emit_depth not in ("full", "model"):
        raise ValueError(f"emit_depth must be 'full' or 'model', got {cfg.emit_depth!r}")


def model_input_size(cfg: ProgramConfig, spec: ModelSpec, oh: int, ow: int) -> Tuple[int, int]:
    """The model input's size for an output size: depth_resolution² for a
    square-only model (DepthPro), else the patch-aligned aspect-kept size."""
    if spec.square_only:
        return cfg.depth_resolution, cfg.depth_resolution
    return patch_aligned_size(oh, ow, cfg.depth_resolution, spec.patch_size)


def ema_shape(cfg: ProgramConfig, spec: ModelSpec, frame_h: int, frame_w: int) -> Tuple[int, int]:
    """Model-resolution depth shape (= the EMA carry shape) for a capture
    shape, as the JAX package names it: the model input's size.  A model
    whose depth has another size (DepthPro's is twice its input's side)
    passes its first frame through the EMA and carries its own size after."""
    oh, ow = process_frame_size(frame_h, frame_w, cfg.output_height)
    return model_input_size(cfg, spec, oh, ow)


class FrameProgram:
    """The stages for one ProgramConfig and model; holds no frame state.

    `streams` 0 takes one frame [H, W, 4|3]; S > 0 takes a stream axis,
    frames [S, H, W, 4|3], and every stage's tensors carry it in front.
    `ranges`: the model's module ranges, shared by the programs of one
    model (a new one otherwise)."""

    def __init__(self, cfg: ProgramConfig, model: torch.nn.Module,
                 spec: Optional[ModelSpec] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, streams: int = 0,
                 ranges: Optional[ModuleRanges] = None) -> None:
        check_supported(cfg)
        self.cfg = cfg
        self.model = model
        self.ranges = ranges if ranges is not None else ModuleRanges(model)
        self.streams = streams
        self.stateful = callable(getattr(model, "first", None)) and callable(
            getattr(model, "step", None))
        self.spec = spec or get_spec(cfg.model_name)
        self.compute_dtype = compute_dtype
        self.tab = cfg.display_mode == "Half-TAB"
        self._fused_cfg = (cfg.quality == "high" and cfg.display_mode in HALF_MODES
                           and not cfg.fill_16_9)

    def output_size(self, h0: int, w0: int) -> Tuple[int, int]:
        return process_frame_size(h0, w0, self.cfg.output_height)

    def fused(self, h0: int, w0: int) -> bool:
        """Whether a capture of this size takes the fused tail (the halved
        axis must be even; an odd one takes the generic tail)."""
        oh, ow = self.output_size(h0, w0)
        return self._fused_cfg and (oh if self.tab else ow) % 2 == 0

    def preprocess(self, frame_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[H,W,4|3] u8 BGRA → (rgb, model input [1,mh,mw,3]): rgb is the eye
        buffer [3,eh,ew] f32 on the fused tail, the frame [oh,ow,3] in the
        compute dtype on the generic tail.  With a stream axis, [S,H,W,4|3]
        → ([S,...], model input [S,mh,mw,3])."""
        if self.fused(frame_u8.shape[-3], frame_u8.shape[-2]):
            return self._fused_preprocess(frame_u8)
        return self._shared_preprocess(frame_u8)

    def _batch(self, x: torch.Tensor) -> torch.Tensor:
        """The model's batch: the stream axis, or one frame as a batch of 1."""
        return x if self.streams else x[None]

    def _resize_for_model(self, x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
        """[N, oh, ow, C] → the model input's size: bilinear without
        antialias to depth_resolution² for a square-only model, as the JAX
        program resizes it, else bicubic with antialias."""
        size = model_input_size(self.cfg, self.spec, oh, ow)
        if self.spec.square_only:
            return resize(x, size, mode="bilinear")
        return resize(x, size, mode="bicubic", antialias=True)

    def _model_input(self, mi: torch.Tensor) -> torch.Tensor:
        """[1,mh,mw,3] resized capture (0..255) → normalised model input."""
        return normalize_for_model(mi / 255.0, self.spec.norm_family).to(self.compute_dtype)

    def _shared_preprocess(self, frame_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h0, w0 = frame_u8.shape[-3], frame_u8.shape[-2]
        oh, ow = self.output_size(h0, w0)
        rgb = bgra_to_rgb(frame_u8).to(self.compute_dtype)
        if (oh, ow) != (h0, w0):
            rgb = resize(rgb, (oh, ow), mode="bilinear", antialias=oh < h0)
        mi = self._resize_for_model(self._batch(rgb), oh, ow)
        return rgb, self._model_input(mi)

    def _fused_preprocess(self, frame_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h0, w0 = frame_u8.shape[-3], frame_u8.shape[-2]
        oh, ow = self.output_size(h0, w0)
        planar = bgra_to_rgb(frame_u8).movedim(-1, -3).float()
        if (oh, ow) != (h0, w0):
            planar = resize(planar[..., None], (oh, ow), mode="bilinear",
                            antialias=oh < h0)[..., 0]
        mi = self._resize_for_model(planar.to(self.compute_dtype)[..., None], oh, ow)[..., 0]
        model_in = self._model_input(self._batch(mi.movedim(-3, -1)))
        # pair-mean squeeze to the eye size: the reference viewer samples its
        # half-size viewports at texel-pair midpoints, i.e. (a+b)/2
        if self.tab:
            rgb_h = (planar[..., 0::2, :] + planar[..., 1::2, :]) * 0.5
        else:
            rgb_h = (planar[..., 0::2] + planar[..., 1::2]) * 0.5
        return rgb_h.contiguous(), model_in

    def model_stage(self, model_in: torch.Tensor, carry: Tuple = (),
                    fresh: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Tuple]:
        """→ (raw depth [mh, mw], or [S, mh, mw] with a stream axis; the
        model's next carry).  A stateful model runs `first` on an empty carry
        and `step` on its carry; a stateless one passes the carry through.

        `fresh` ([S] bool, stream axis only): rows without a new frame.  A
        model whose carry has a stream axis (`carry_per_stream`, VDA's
        caches [S, P, 31, C]) keeps those rows' carry as it was, bit for bit,
        as JAX masks every leaf (`programs.py:490-499`); a carry that depends
        on the shape alone (the BEiT tables) is one set for the batch and is
        never masked, where JAX's mask cannot broadcast (ROADMAP C9)."""
        if not self.stateful:
            raw = self.model(model_in)
        elif not carry:
            raw, carry = self.model.first(model_in)
        else:
            raw, new = self.model.step(model_in, carry)
            if fresh is not None and getattr(self.model, "carry_per_stream", True):
                new = tuple(torch.where(fresh.view(-1, *(1,) * (n.ndim - 1)), n, o)
                            for n, o in zip(new, carry))
            carry = new
        return (raw if self.streams else raw[0]), carry

    def post_stage(self, raw_depth: torch.Tensor, ema_prev: torch.Tensor) -> torch.Tensor:
        """Depth post + EMA at model resolution; a carry of another shape
        passes through (the stabilizer resets on a shape change).  With a
        stream axis each row on its own (the normalisation is per frame)."""
        if self.streams:
            return torch.stack([self._post_one(r, e) for r, e in zip(raw_depth, ema_prev)])
        return self._post_one(raw_depth, ema_prev)

    def _post_one(self, raw_depth: torch.Tensor, ema_prev: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        depth = post_process_depth(raw_depth.float(), metric=self.spec.metric,
                                   foreground_scale=cfg.foreground_scale,
                                   aa_strength=cfg.aa_strength)
        if cfg.temporal_smooth and ema_prev.shape == depth.shape:
            depth = torch.where(torch.isnan(ema_prev), depth,
                                ema(ema_prev, depth, cfg.ema_alpha))
        return depth

    @staticmethod
    def upsample_depth(depth_small: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
        """Model resolution → output resolution."""
        if depth_small.shape[-2:] == (oh, ow):
            return depth_small
        return resize(depth_small[..., None], (oh, ow), mode="bilinear")[..., 0]

    def stereo_stage(self, rgb: torch.Tensor, depth_small: torch.Tensor):
        """Generic tail: → (frame u8 HWC, depth at output resolution)."""
        cfg = self.cfg
        depth = self.upsample_depth(depth_small, rgb.shape[-3], rgb.shape[-2])
        compose = stereo_compose_streams if self.streams else stereo_compose
        sbs = compose(rgb.float(), depth, ipd=cfg.ipd,
                             depth_strength=cfg.depth_strength,
                             convergence=cfg.convergence, display_mode=cfg.display_mode,
                             quality=cfg.quality, feather=cfg.edge_feather,
                             fill_16_9=cfg.fill_16_9)
        return quantize_u8(sbs).contiguous(), depth

    def post_stereo_stage(self, raw_depth: torch.Tensor, ema_prev: torch.Tensor,
                          rgb_h: torch.Tensor):
        """Fused tail: → (frame u8 HWC, depth out, next EMA carry)."""
        cfg = self.cfg
        depth_small = self.post_stage(raw_depth, ema_prev)
        eh, ew = rgb_h.shape[-2], rgb_h.shape[-1]
        oh, ow = (2 * eh, ew) if self.tab else (eh, 2 * ew)
        if cfg.emit_depth == "full":
            depth = self.upsample_depth(depth_small, oh, ow)
            if self.tab:
                dep_h = (depth[..., 0::2, :] + depth[..., 1::2, :]) * 0.5
            else:
                dep_h = (depth[..., 0::2] + depth[..., 1::2]) * 0.5
        else:
            depth = depth_small
            dep_h = resize_halved(depth_small[..., None], (oh, ow),
                                  halve_axis=0 if self.tab else 1)[..., 0]
        sbs = dibr_pair_half(
            rgb_h, dep_h.contiguous(), ipd=cfg.ipd,
            depth_strength=cfg.depth_strength, convergence=cfg.convergence,
            feather=FEATHER_WIDTH if cfg.edge_feather else 0.0,
            arrangement="tab" if self.tab else "sbs")
        return sbs, depth, depth_small

    def __call__(self, frame_u8: torch.Tensor, state: FrameState,
                 fresh: Optional[torch.Tensor] = None):
        """One frame (or one step of S streams): each stage inside a
        `d2s.<stage>` profiler and NVTX range."""
        with annotate("d2s.preprocess"):
            rgb, model_in = self.preprocess(frame_u8)
        with annotate("d2s.model"), self.ranges:
            raw, carry = self.model_stage(model_in, state.model, fresh)
        if self.fused(frame_u8.shape[-3], frame_u8.shape[-2]):
            with annotate("d2s.tail"):
                sbs, depth, small = self.post_stereo_stage(raw, state.ema_depth, rgb)
        else:
            with annotate("d2s.post"):
                small = self.post_stage(raw, state.ema_depth)
            with annotate("d2s.stereo"):
                sbs, depth = self.stereo_stage(rgb, small)
            if self.cfg.emit_depth == "model":
                depth = small
        return sbs, depth, FrameState(ema_depth=small, model=carry)


class _Switched:
    """A FrameProgram behind the viewer's live switches, with its carried
    states: the part `ProgramCache` and `BatchedProgramCache` share.

    The setters (`set_display_mode`, `cycle_display_mode`,
    `set_depth_strength`, `adjust_depth_strength`, `reset_depth_strength`,
    `toggle_feather`) may run on any thread; a switch is applied at the start
    of the next frame, and the model and the carried states survive it."""

    MAX_DEPTH_STRENGTH = 10.0  # the reference viewer's clamp

    def __init__(self, cfg: ProgramConfig, model: torch.nn.Module,
                 spec: Optional[ModelSpec], compute_dtype: torch.dtype, streams: int) -> None:
        self._model = model
        self._compute_dtype = compute_dtype
        self._streams = streams
        self._ranges = ModuleRanges(model)
        self.program = FrameProgram(cfg, model, spec, compute_dtype, streams, self._ranges)
        self.cfg = cfg
        self.spec = self.program.spec
        self.stateful = self.program.stateful
        self.device = next(model.parameters()).device
        self._states: Dict[Tuple[int, int, int], FrameState] = {}
        # (display mode, depth strength, edge feather) requested for the next
        # frame; setters run on key-handler threads while the frame thread
        # applies it (RLock: adjust_* call set_* inside the lock)
        self._pending: Optional[Tuple[str, float, bool]] = None
        self._variant_lock = threading.RLock()
        self._strength_default = float(cfg.depth_strength)

    # ---- live switches ---------------------------------------------------

    @staticmethod
    def _variant_key(cfg: ProgramConfig) -> Tuple[str, float, bool]:
        return (cfg.display_mode, float(cfg.depth_strength), bool(cfg.edge_feather))

    def _pending_key(self) -> Tuple[str, float, bool]:
        return self._pending or self._variant_key(self.cfg)

    def set_display_mode(self, mode: str) -> None:
        """Request a display-mode switch for the next frame."""
        if mode not in DISPLAY_MODES:
            raise ValueError(f"unknown display mode {mode!r}")
        with self._variant_lock:
            self._pending = (mode,) + self._pending_key()[1:]

    def cycle_display_mode(self, delta: int = 1) -> str:
        """Step through DISPLAY_MODES (the viewer's hot key); returns the
        newly requested mode."""
        with self._variant_lock:
            idx = (DISPLAY_MODES.index(self._pending_key()[0]) + delta) % len(DISPLAY_MODES)
            self.set_display_mode(DISPLAY_MODES[idx])
        return DISPLAY_MODES[idx]

    def set_depth_strength(self, value: float) -> float:
        """Request a depth strength, clamped to [0, MAX_DEPTH_STRENGTH]."""
        value = min(self.MAX_DEPTH_STRENGTH, max(0.0, float(value)))
        with self._variant_lock:
            mode, _, feather = self._pending_key()
            self._pending = (mode, value, feather)
        return value

    def adjust_depth_strength(self, delta: float = 0.5) -> float:
        """Step the depth strength by ±delta (the viewer steps 0.5)."""
        with self._variant_lock:
            return self.set_depth_strength(self._pending_key()[1] + delta)

    def reset_depth_strength(self) -> float:
        """Back to the configured depth strength."""
        return self.set_depth_strength(self._strength_default)

    def toggle_feather(self) -> bool:
        """Toggle per-eye edge feathering; returns the new state."""
        with self._variant_lock:
            mode, strength, feather = self._pending_key()
            self._pending = (mode, strength, not feather)
        return not feather

    @property
    def display_mode(self) -> str:
        return self._pending_key()[0]

    @property
    def depth_strength(self) -> float:
        return self._pending_key()[1]

    @property
    def edge_feather(self) -> bool:
        return self._pending_key()[2]

    def _apply_pending(self) -> None:
        # clear-pending → rebuild → swap under one lock: a setter racing the
        # swap sees either its pending key or the new cfg
        with self._variant_lock:
            key, self._pending = self._pending, None
            if key is None or key == self._variant_key(self.cfg):
                return
            cfg = dataclasses.replace(self.cfg, display_mode=key[0],
                                      depth_strength=key[1], edge_feather=key[2])
            self.program = FrameProgram(cfg, self._model, self.spec, self._compute_dtype,
                                        self._streams, self._ranges)
            self.cfg = cfg

    # ---- frames ----------------------------------------------------------

    def _as_tensor(self, frame_u8) -> torch.Tensor:
        if isinstance(frame_u8, np.ndarray):
            frame_u8 = torch.from_numpy(frame_u8)
        return frame_u8.to(self.device, non_blocking=True)

    def _init_state(self, h: int, w: int) -> FrameState:
        return init_state(*ema_shape(self.cfg, self.spec, h, w), device=self.device,
                          streams=self._streams)

    def reset(self) -> None:
        self._states.clear()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def warmup(self, frame_shape: Tuple[int, ...], steps: int = 2) -> Dict[str, float]:
        """Run each stage once on a zero frame of `frame_shape` (one stream's
        capture shape; S of them with a stream axis), first-call seconds per
        stage (kernel builds and cuDNN/cuBLAS plan selection land here),
        then `steps` whole frames (a stateful model's first frame, then
        steps); every carried state is discarded after.  Keys: pre_s,
        model_s, then tail_s (fused tail) or post_s and stereo_s (generic
        tail).  The whole is the span `d2s.setup.warmup` in the process's
        span log (`profiling.PROCESS_LOG`), each first call a child span
        `d2s.setup.warmup.<stage>`."""
        with annotate("d2s.setup.warmup", log=PROCESS_LOG):
            if self._pending is not None:
                self._apply_pending()
            p = self.program
            shape = ((self._streams,) if self._streams else ()) + tuple(frame_shape)
            dummy = torch.zeros(shape, dtype=torch.uint8, device=self.device)
            state = self._init_state(frame_shape[0], frame_shape[1])
            report: Dict[str, float] = {}

            def timed(name, fn, *args):
                with annotate(f"d2s.setup.warmup.{name[:-2]}", log=PROCESS_LOG) as span:
                    out = fn(*args)
                    self._sync()
                report[name] = span.seconds
                return out

            rgb, model_in = timed("pre_s", p.preprocess, dummy)
            raw, _ = timed("model_s", p.model_stage, model_in, state.model)
            if p.fused(frame_shape[0], frame_shape[1]):
                timed("tail_s", p.post_stereo_stage, raw, state.ema_depth, rgb)
            else:
                small = timed("post_s", p.post_stage, raw, state.ema_depth)
                timed("stereo_s", p.stereo_stage, rgb, small)
            for _ in range(max(1, steps)):
                self(dummy)
            self._sync()
            self.reset()
            return report


class ProgramCache(_Switched):
    """A frame program with carried state per (stream, output size), and the
    viewer's live switches.

    `program(frame_u8, stream=0) -> (sbs_u8 [H',W',3], depth)` on the model's
    device; a frame given as a numpy array is uploaded first."""

    def __init__(self, cfg: ProgramConfig, model: torch.nn.Module,
                 spec: Optional[ModelSpec] = None,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__(cfg, model, spec, compute_dtype, streams=0)

    @torch.inference_mode()
    def __call__(self, frame_u8, stream: int = 0):
        if self._pending is not None:
            self._apply_pending()
        frame = self._as_tensor(frame_u8)
        h, w = frame.shape[0], frame.shape[1]
        oh, ow = process_frame_size(h, w, self.cfg.output_height)
        key = (stream, oh, ow)
        state = self._states.get(key)
        if state is None:
            state = self._init_state(h, w)
        sbs, depth, new_state = self.program(frame, state)
        self._states[key] = new_state
        return sbs, depth


class BatchedProgramCache(_Switched):
    """S concurrent streams through one FrameProgram over a stream axis (JAX
    `programs.py:612-671`), with the live switches `ProgramCache` has.

    `program(frames [S,H,W,4|3] u8, fresh=None) -> (sbs [S,H',W',3] u8,
    depth [S, ...])`: the model runs at batch S, one K1 launch covers the S
    frames.  The carried state is per (S, output size): the EMA [S, mh, mw]
    and the model's carry, which the first frame of a stateful model builds
    for every row (VDA's caches [S, P, 31, C]; BEiT's and ZoeDepth's tables
    one set for the batch).  `fresh` ([S] bool) marks the rows that hold a
    new frame: a stale row is computed and its EMA advances, as in JAX, but
    a per-stream model carry keeps its row bit-equal (`model_stage`)."""

    def __init__(self, cfg: ProgramConfig, model: torch.nn.Module,
                 spec: Optional[ModelSpec] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, num_streams: int = 2) -> None:
        if num_streams < 1:
            raise ValueError(f"num_streams must be at least 1, got {num_streams}")
        self.num_streams = num_streams
        super().__init__(cfg, model, spec, compute_dtype, streams=num_streams)

    @torch.inference_mode()
    def __call__(self, frames, fresh=None):
        if self._pending is not None:
            self._apply_pending()
        frames = self._as_tensor(frames)
        if frames.ndim != 4 or frames.shape[0] != self.num_streams:
            raise ValueError(f"BatchedProgramCache({self.num_streams} streams) takes frames "
                             f"[{self.num_streams},H,W,C], got {tuple(frames.shape)}")
        s, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        oh, ow = process_frame_size(h, w, self.cfg.output_height)
        key = (s, oh, ow)
        state = self._states.get(key)
        if state is None:
            state = self._init_state(h, w)
            fresh = None  # the first frame builds every row's carry
        if fresh is not None:
            fresh = torch.as_tensor(np.asarray(fresh, bool)).to(self.device, non_blocking=True)
        sbs, depth, new_state = self.program(frames, state, fresh)
        self._states[key] = new_state
        return sbs, depth
