"""The frame path: preprocess → model → depth post + EMA + DIBR stereo tail.

Port of the fused branch of `desktop2stereo_tpu/pipeline/programs.py`
(`_build_step` with the Half-SBS / Half-TAB fused stereo tail).  Three
stages, kept as separate methods so each can be timed on its own:

- `preprocess`: u8 BGRA capture → planar f32 [3,H,W] → (optional output
  downscale) → bicubic+antialias model input (NHWC, compute dtype) and the
  pair-mean squeeze to the eye buffer [3, eh, ew];
- `model_stage`: the depth network at model resolution;
- `post_stereo_stage`: depth post + temporal EMA at model resolution, the
  depth resize to eye size (`resize_halved`, or upsample then pair-mean when
  the full-resolution depth is an output), and the DIBR kernel, which writes
  the finished u8 HWC frame.

PyTorch runs these eagerly; there is no jit analog.  Other display modes,
fast quality, fill_16_9 and odd halved axes raise NotImplementedError naming
the ROADMAP item; nothing falls back to another path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.core.registry import ModelSpec, get_spec
from desktop2stereo_tpu_torch.ops.depth_post import ema, post_process_depth
from desktop2stereo_tpu_torch.ops.kernels.dibr import dibr_pair_half
from desktop2stereo_tpu_torch.ops.normalize import (
    bgra_to_rgb, normalize_for_model, process_frame_size)
from desktop2stereo_tpu_torch.ops.resize import (
    patch_aligned_size, resize, resize_halved)

FEATHER_WIDTH = 0.02  # per-eye edge feather band, fraction of the view
HALF_MODES = ("Half-SBS", "Half-TAB")


class FrameState(NamedTuple):
    """Carried state: the EMA depth at model resolution, NaN before frame 1."""

    ema_depth: torch.Tensor  # [mh, mw] float32


def init_state(height: int, width: int, device: torch.device | str = "cpu") -> FrameState:
    return FrameState(ema_depth=torch.full((height, width), float("nan"),
                                           dtype=torch.float32, device=device))


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
    quality: str
    edge_feather: bool = False
    fill_16_9: bool = False
    emit_depth: str = "full"  # "full": depth at output res; "model": model res


def check_supported(cfg: ProgramConfig) -> None:
    """Raise NotImplementedError for what this slice of the port lacks."""
    if cfg.display_mode not in HALF_MODES:
        raise NotImplementedError(
            f"display mode {cfg.display_mode!r}: the port renders Half-SBS and "
            f"Half-TAB; other modes are ROADMAP A2")
    if cfg.quality != "high":
        raise NotImplementedError(
            f"quality {cfg.quality!r}: the port has the high-quality DIBR tail "
            f"only; fast quality (the warp kernel K3) is ROADMAP A2")
    if cfg.fill_16_9:
        raise NotImplementedError("fill_16_9 (per-eye 16:9 padding) is ROADMAP A2")
    if cfg.emit_depth not in ("full", "model"):
        raise ValueError(f"emit_depth must be 'full' or 'model', got {cfg.emit_depth!r}")


def ema_shape(cfg: ProgramConfig, spec: ModelSpec, frame_h: int, frame_w: int) -> Tuple[int, int]:
    """Model-resolution depth shape (= the EMA carry shape) for a capture shape."""
    oh, ow = process_frame_size(frame_h, frame_w, cfg.output_height)
    return patch_aligned_size(oh, ow, cfg.depth_resolution, spec.patch_size)


class FrameProgram:
    """The three stages for one ProgramConfig and model; holds no frame state."""

    def __init__(self, cfg: ProgramConfig, model: torch.nn.Module,
                 spec: Optional[ModelSpec] = None,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        check_supported(cfg)
        self.cfg = cfg
        self.model = model
        self.spec = spec or get_spec(cfg.model_name)
        self.compute_dtype = compute_dtype
        self.tab = cfg.display_mode == "Half-TAB"

    def output_size(self, h0: int, w0: int) -> Tuple[int, int]:
        oh, ow = process_frame_size(h0, w0, self.cfg.output_height)
        if (oh if self.tab else ow) % 2:
            raise NotImplementedError(
                f"output {oh}x{ow}: {self.cfg.display_mode} needs an even "
                f"{'height' if self.tab else 'width'}; odd halved axes take the "
                f"generic tail, ROADMAP A2")
        return oh, ow

    def preprocess(self, frame_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[H,W,4|3] u8 BGRA → (eye buffer [3,eh,ew] f32, model input [1,mh,mw,3])."""
        h0, w0 = frame_u8.shape[0], frame_u8.shape[1]
        oh, ow = self.output_size(h0, w0)
        planar = bgra_to_rgb(frame_u8).permute(2, 0, 1).float()
        if (oh, ow) != (h0, w0):
            planar = resize(planar[..., None], (oh, ow), mode="bilinear",
                            antialias=oh < h0)[..., 0]
        mh, mw = patch_aligned_size(oh, ow, self.cfg.depth_resolution, self.spec.patch_size)
        small = planar.to(self.compute_dtype)[..., None]
        mi = resize(small, (mh, mw), mode="bicubic", antialias=True)[..., 0]
        model_in = normalize_for_model(mi.permute(1, 2, 0)[None] / 255.0,
                                       self.spec.norm_family)
        # pair-mean squeeze to the eye size: the reference viewer samples its
        # half-size viewports at texel-pair midpoints, i.e. (a+b)/2
        if self.tab:
            rgb_h = (planar[:, 0::2] + planar[:, 1::2]) * 0.5
        else:
            rgb_h = (planar[:, :, 0::2] + planar[:, :, 1::2]) * 0.5
        return rgb_h.contiguous(), model_in.to(self.compute_dtype)

    def model_stage(self, model_in: torch.Tensor) -> torch.Tensor:
        return self.model(model_in)[0]

    def post_stage(self, raw_depth: torch.Tensor, ema_prev: torch.Tensor) -> torch.Tensor:
        """Depth post + EMA at model resolution; a carry of another shape
        passes through (the stabilizer resets on a shape change)."""
        cfg = self.cfg
        depth = post_process_depth(raw_depth.float(), metric=self.spec.metric,
                                   foreground_scale=cfg.foreground_scale,
                                   aa_strength=cfg.aa_strength)
        if cfg.temporal_smooth and ema_prev.shape == depth.shape:
            depth = torch.where(torch.isnan(ema_prev), depth,
                                ema(ema_prev, depth, cfg.ema_alpha))
        return depth

    def post_stereo_stage(self, raw_depth: torch.Tensor, ema_prev: torch.Tensor,
                          rgb_h: torch.Tensor):
        """→ (frame u8 HWC, depth out, next EMA carry)."""
        cfg = self.cfg
        depth_small = self.post_stage(raw_depth, ema_prev)
        eh, ew = rgb_h.shape[1], rgb_h.shape[2]
        oh, ow = (2 * eh, ew) if self.tab else (eh, 2 * ew)
        if cfg.emit_depth == "full":
            depth = depth_small
            if depth.shape != (oh, ow):
                depth = resize(depth[..., None], (oh, ow), mode="bilinear")[..., 0]
            if self.tab:
                dep_h = (depth[0::2] + depth[1::2]) * 0.5
            else:
                dep_h = (depth[:, 0::2] + depth[:, 1::2]) * 0.5
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

    def __call__(self, frame_u8: torch.Tensor, state: FrameState):
        rgb_h, model_in = self.preprocess(frame_u8)
        raw = self.model_stage(model_in)
        sbs, depth, small = self.post_stereo_stage(raw, state.ema_depth, rgb_h)
        return sbs, depth, FrameState(ema_depth=small)


class ProgramCache:
    """Frame programs with carried state per (stream, output shape).

    `program(frame_u8, stream=0) -> (sbs_u8 [H',W',3], depth)` on the model's
    device; a frame given as a numpy array is uploaded first."""

    def __init__(self, cfg: ProgramConfig, model: torch.nn.Module,
                 spec: Optional[ModelSpec] = None,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        self.program = FrameProgram(cfg, model, spec, compute_dtype)
        self.cfg = cfg
        self.spec = self.program.spec
        self.device = next(model.parameters()).device
        self._states: Dict[Tuple[int, int, int], FrameState] = {}

    def _as_tensor(self, frame_u8) -> torch.Tensor:
        if isinstance(frame_u8, np.ndarray):
            frame_u8 = torch.from_numpy(frame_u8)
        return frame_u8.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def __call__(self, frame_u8, stream: int = 0):
        frame = self._as_tensor(frame_u8)
        h, w = frame.shape[0], frame.shape[1]
        oh, ow = process_frame_size(h, w, self.cfg.output_height)
        key = (stream, oh, ow)
        state = self._states.get(key)
        if state is None:
            state = init_state(*ema_shape(self.cfg, self.spec, h, w), device=self.device)
        sbs, depth, new_state = self.program(frame, state)
        self._states[key] = new_state
        return sbs, depth

    def reset(self) -> None:
        self._states.clear()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def warmup(self, frame_shape: Tuple[int, ...], steps: int = 2) -> Dict[str, float]:
        """Run each stage once on a zero frame (first-call seconds per stage:
        kernel builds and cuDNN/cuBLAS plan selection land here), then
        `steps` whole frames; the carried state is discarded after."""
        p = self.program
        dummy = torch.zeros(frame_shape, dtype=torch.uint8, device=self.device)
        state = init_state(*ema_shape(self.cfg, self.spec, frame_shape[0], frame_shape[1]),
                           device=self.device)
        report: Dict[str, float] = {}
        t0 = time.perf_counter()
        rgb_h, model_in = p.preprocess(dummy)
        self._sync()
        report["pre_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = p.model_stage(model_in)
        self._sync()
        report["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p.post_stereo_stage(raw, state.ema_depth, rgb_h)
        self._sync()
        report["tail_s"] = time.perf_counter() - t0
        for _ in range(max(1, steps)):
            self(dummy)
        self._sync()
        self.reset()
        return report
