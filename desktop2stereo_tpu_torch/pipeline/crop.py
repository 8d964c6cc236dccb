"""Letterbox / pillarbox auto-crop detection, and the crop in front of a program.

Port of `desktop2stereo_tpu/pipeline/crop.py` (the reference's movie-crop
pipeline, reference xr_viewer/crop.py:200-430): a stats pass samples luma
on a sparse row/column grid and counts the contiguous uniform (low-std) bar
runs from each edge with a cumprod; a host-side controller turns the six
stats into a crop rectangle with the same guards (minimum bar size,
top/bottom symmetry, edge trim, minimum removed area, dark-scene rejection)
and hysteresis (a full-frame result must repeat before the crop resets).

In the JAX package the stats run on the host frame before its upload.  In
the port the program receives the frame after `FrameEngine`'s staging
upload, so the stats run on the frame's device and only the six stats cross
to the host, once every `poll_every` frames; the crop is a slice on the
device.  `CropProgram` is that crop in front of a `ProgramCache`, the
object `FrameEngine` drives where the CLI is given `--crop`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

UNIFORM_STD = 6.0        # reference crop.py:390
BRIGHT_LUMA = 20.0       # reference crop.py:395
Crop = Tuple[float, float, float, float]  # (u0, v0, uw, vh)
FULL: Crop = (0.0, 0.0, 1.0, 1.0)
RGB = (0, 1, 2)
BGR = (2, 1, 0)          # the channel order of a BGRA capture frame


@functools.lru_cache(maxsize=16)
def _sample_plan(w: int, h: int):
    """Sparse sampling grid (reference crop.py:300-330 _movie_crop_sample_plan)."""
    x0, x1 = int(w * 0.10), max(int(w * 0.10) + 1, int(w * 0.90))
    row_stride = max(1, (h + 359) // 360)
    y_rows = np.arange(0, h, row_stride, dtype=np.int64)
    if y_rows.size == 0 or int(y_rows[-1]) != h - 1:
        y_rows = np.append(y_rows, h - 1)
    step_x = max(1, (x1 - x0) // 128)
    center_mask = (y_rows >= int(h * 0.35)) & (y_rows < int(h * 0.65))

    y0c, y1c = int(h * 0.10), max(int(h * 0.10) + 1, int(h * 0.90))
    col_stride = max(1, (w + 359) // 360)
    x_cols = np.arange(0, w, col_stride, dtype=np.int64)
    if x_cols.size == 0 or int(x_cols[-1]) != w - 1:
        x_cols = np.append(x_cols, w - 1)
    step_y = max(1, (y1c - y0c) // 128)
    return dict(x0=x0, x1=x1, step_x=step_x, y_rows=y_rows,
                center_mask=center_mask, y0c=y0c, y1c=y1c, step_y=step_y,
                x_cols=x_cols)


def _luma(px: torch.Tensor, channels: Sequence[int]) -> torch.Tensor:
    r, g, b = (px[..., c].float() for c in channels)
    return r * 0.2126 + g * 0.7152 + b * 0.0722


def _run(uniform: torch.Tensor) -> torch.Tensor:
    """Length of the leading run of ones."""
    return torch.cumprod(uniform, dim=0).sum()


def crop_stats(rgb: torch.Tensor, channels: Sequence[int] = RGB) -> torch.Tensor:
    """frame [H,W,C] (0..255) → stats [6] f32 on its device: (top_run,
    bottom_run, center_mean, center_bright_frac, left_run, right_run) over
    the sample grid.  `channels` names the frame's R, G and B channels
    (`BGR` for a BGRA capture); only the sampled pixels are read."""
    H, W = rgb.shape[0], rgb.shape[1]
    plan = _sample_plan(W, H)
    dev = rgb.device

    y_rows = torch.from_numpy(plan["y_rows"]).to(dev)
    luma_r = _luma(rgb[y_rows, plan["x0"]:plan["x1"]:plan["step_x"]], channels)
    row_std = luma_r.std(dim=1, correction=0)
    uniform_row = (row_std < UNIFORM_STD).to(torch.int32)
    top_run = _run(uniform_row)
    bottom_run = _run(uniform_row.flip(0))

    center = torch.from_numpy(plan["center_mask"]).to(dev, torch.float32)
    row_mean = luma_r.mean(dim=1)
    bright = (luma_r > BRIGHT_LUMA).float().mean(dim=1)
    denom = center.sum().clamp_min(1.0)
    center_mean = (row_mean * center).sum() / denom
    center_bright = (bright * center).sum() / denom

    x_cols = torch.from_numpy(plan["x_cols"]).to(dev)
    luma_c = _luma(rgb[plan["y0c"]:plan["y1c"]:plan["step_y"], x_cols], channels)
    col_std = luma_c.std(dim=0, correction=0)
    uniform_col = (col_std < UNIFORM_STD).to(torch.int32)
    left_run = _run(uniform_col)
    right_run = _run(uniform_col.flip(0))

    return torch.stack([
        top_run.float(), bottom_run.float(), center_mean, center_bright,
        left_run.float(), right_run.float(),
    ])


# Decision thresholds — BEHAVIORAL constants matching the reference's
# _movie_crop_from_stats guards (reference crop.py:236-300):
_MIN_BAR_FRAC = 0.035     # a bar thinner than max(8px, 3.5%) is noise
_ASYM_BASE_PX = 18        # opposing bars may differ ≤ max(18px, 25% of big)
_EDGE_TRIM_FRAC = 0.004   # shave 2..8px of compression bleed off the edge
_MIN_REMOVED_FRAC = 0.07  # a crop must remove ≥ max(16px, 7%) to act
_DARK_CENTER_MEAN = 14.0  # dark-scene rejection: the centre must carry
_DARK_CENTER_BRIGHT = 0.035  # real content, not a fade-to-black
_MIN_DETECT_DIM = 64      # tiny frames are never auto-cropped


def _axis_span(first_run: int, last_run: int, samples, size: int):
    """One axis of the detector: uniform-run counts from both edges →
    (offset_px, length_px) of the content span, or None if any guard
    rejects (bars too thin, too asymmetric, or removing too little)."""
    n = len(samples)
    if not (0 < first_run and 0 < last_run and first_run + last_run < n):
        return None
    far = n - last_run - 1
    if far < first_run:
        return None
    lo = int(samples[min(first_run, n - 1)])
    hi = size - min(size, int(samples[far]) + 1)
    if min(lo, hi) < max(8, int(size * _MIN_BAR_FRAC)):
        return None
    if max(lo, hi) - min(lo, hi) > max(_ASYM_BASE_PX, int(max(lo, hi) * 0.25)):
        return None
    trim = max(2, min(8, int(round(size * _EDGE_TRIM_FRAC))))
    start = max(0, min(lo + trim, size - 2))
    stop = max(start + 1, size - hi - trim)
    if size - (stop - start) < max(16, int(size * _MIN_REMOVED_FRAC)):
        return None
    return start, stop - start


def crop_from_stats(stats, w: int, h: int) -> Crop:
    """Six stats → UV crop rect.  Same guards as the reference
    (crop.py:236-300), one axis-generic helper applied to rows then
    columns; the dark-scene gate applies to the letterbox (top/bottom) axis
    only."""
    if w < _MIN_DETECT_DIM or h < _MIN_DETECT_DIM:
        return FULL  # reference small-frame guard: never crop tiny captures
    plan = _sample_plan(w, h)
    u0, v0, uw, vh = FULL
    tb = _axis_span(int(round(float(stats[0]))), int(round(float(stats[1]))),
                    plan["y_rows"], h)
    if tb is not None and (float(stats[2]) >= _DARK_CENTER_MEAN
                           or float(stats[3]) >= _DARK_CENTER_BRIGHT):
        v0, vh = tb[0] / h, tb[1] / h
    lr = _axis_span(int(round(float(stats[4]))), int(round(float(stats[5]))),
                    plan["x_cols"], w)
    if lr is not None:
        u0, uw = lr[0] / w, lr[1] / w
    return (u0, v0, uw, vh)


class CropController:
    """Hysteresis wrapper (reference crop.py:202-217): a detected crop
    applies immediately (with a 2px deadband); a full-frame result must
    repeat `full_hits_reset` times before the crop resets."""

    def __init__(self, full_hits_reset: int = 3, poll_every: int = 30):
        self.crop: Crop = FULL
        self.full_hits = 0
        self.full_hits_reset = full_hits_reset
        self.poll_every = poll_every
        self._frame = 0

    @property
    def active(self) -> bool:
        return self.crop != FULL

    def update(self, rgb: torch.Tensor, channels: Sequence[int] = RGB) -> Crop:
        """Call once per frame with the frame on its device; polls every
        `poll_every` frames (the stats' six values are read to the host)."""
        self._frame += 1
        if (self._frame - 1) % self.poll_every != 0:
            return self.crop
        h, w = rgb.shape[0], rgb.shape[1]
        stats = crop_stats(rgb, channels).cpu().numpy()
        detected = crop_from_stats(stats, w, h)
        if detected != FULL:
            self.full_hits = 0
            old = self.crop
            # 2-px deadband per component in ITS OWN axis: (u0, uw) are
            # width-normalized, (v0, vh) height-normalized
            tol = (2.0 / max(w, 1), 2.0 / max(h, 1),
                   2.0 / max(w, 1), 2.0 / max(h, 1))
            if max(abs(old[i] - detected[i]) / tol[i] for i in range(4)) >= 1.0:
                self.crop = detected
        else:
            self.full_hits += 1
            if self.full_hits >= self.full_hits_reset and self.active:
                self.crop = FULL
        return self.crop


def apply_crop(img: torch.Tensor, crop: Crop) -> torch.Tensor:
    """Slice [H,W,...] by a UV crop rect (python floats); a strided view.

    The rect is clamped into [0,1] first: a manual rect like
    (-0.05, 0, 1, 1) would otherwise index from the wrong edge."""
    if crop == FULL:
        return img
    H, W = img.shape[0], img.shape[1]
    u0 = min(max(crop[0], 0.0), 1.0)
    v0 = min(max(crop[1], 0.0), 1.0)
    uw = min(max(crop[2], 0.0), 1.0 - u0)
    vh = min(max(crop[3], 0.0), 1.0 - v0)
    y0 = int(round(v0 * H))
    x0 = int(round(u0 * W))
    y1 = min(H, y0 + max(1, int(round(vh * H))))
    x1 = min(W, x0 + max(1, int(round(uw * W))))
    return img[y0:y1, x0:x1]


class CropProgram:
    """A program (`ProgramCache`) behind the letterbox crop of the CLI's
    `--crop` (JAX `cli.py:210-244`): `rect=None` detects the crop per stream
    with a `CropController` on the BGRA frame, a UV rect crops every frame
    by it.  The cropped view is made contiguous on the frame's device before
    the program runs.  `device`, `warmup` and `base` (the program the live
    switches target) are what `FrameEngine` and the CLI need."""

    def __init__(self, base, rect: Optional[Crop] = None) -> None:
        self.base = base
        self.device = base.device
        self.rect = rect
        self.controllers: Dict[int, CropController] = {}

    def crop_for(self, frame: torch.Tensor, stream: int = 0) -> Crop:
        if self.rect is not None:
            return self.rect
        ctl = self.controllers.get(stream)
        if ctl is None:
            ctl = self.controllers[stream] = CropController()
        return ctl.update(frame, channels=BGR)

    def __call__(self, frame, stream: int = 0):
        if isinstance(frame, np.ndarray):
            frame = torch.from_numpy(frame)
        crop = apply_crop(frame, self.crop_for(frame, stream))
        return self.base(crop.contiguous(), stream=stream)

    def warmup(self, frame_shape: Tuple[int, ...], steps: int = 2):
        """Auto crop starts full-frame; a manual rect warms its crop's shape."""
        if self.rect is not None:
            h = max(1, int(round(self.rect[3] * frame_shape[0])))
            w = max(1, int(round(self.rect[2] * frame_shape[1])))
            frame_shape = (h, w) + tuple(frame_shape[2:])
        return self.base.warmup(frame_shape, steps)
