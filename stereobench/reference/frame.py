"""The frame path around the model, in plain float32 PyTorch: capture →
model input, raw depth → display depth (percentile normalisation, gamma,
foreground scale, Gaussian anti-aliasing), the per-feed EMA, and the
Half-SBS tail (depth resized to the output, both eye buffers pair-mean
halved, the DIBR of `dibr.py`, u8).

Resizes are `F.interpolate` (align_corners False, antialias where a frame
shrinks with the bicubic model resize).  The percentile normalisation
sorts a strided subsample of at most 6 144 values, as the display path
defines it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stereobench.reference import dibr

PERCENTILE = 2.0
SUBSAMPLE_CAP = 6_144
GAMMA = 1.45


def output_size(h: int, w: int, target: int) -> Tuple[int, int]:
    """Even-aligned aspect-keeping output size for a capture of h x w."""
    if target >= h:
        return h, w
    return (target // 2) * 2, (int(w * target / h) // 2) * 2


def planar_rgb(frame_bgra: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """u8 BGRA [H, W, 4] → RGB f32 [3, oh, ow] (0..255) at the output size."""
    rgb = frame_bgra[..., :3].flip(-1).permute(2, 0, 1).float()
    if tuple(rgb.shape[-2:]) != tuple(size):
        rgb = F.interpolate(rgb[None], size=size, mode="bilinear", align_corners=False,
                            antialias=size[0] < rgb.shape[-2])[0]
    return rgb


def model_input(planar: torch.Tensor, size: Tuple[int, int], mode: str, antialias: bool,
                mean, std, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[3, oh, ow] (0..255) → normalized NCHW [1, 3, mh, mw] in `dtype`: the
    separable resize one axis at a time (rows, then columns), each pass's
    result held in `dtype`, then the normalisation in `dtype`."""
    x = planar[None].float()
    if tuple(x.shape[-2:]) != tuple(size):
        x = F.interpolate(x, size=(size[0], x.shape[-1]), mode=mode, align_corners=False,
                          antialias=antialias).to(dtype).float()
        x = F.interpolate(x, size=size, mode=mode, align_corners=False, antialias=antialias)
    x = x.to(dtype)
    mean = torch.tensor(mean, dtype=dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(std, dtype=dtype, device=x.device).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


def _subsample(flat: torch.Tensor) -> torch.Tensor:
    n = flat.shape[0]
    return flat if n <= SUBSAMPLE_CAP else flat[:: (n + SUBSAMPLE_CAP - 1) // SUBSAMPLE_CAP]


def normalize_depth(raw: torch.Tensor, metric: bool) -> torch.Tensor:
    """Raw depth [H, W] → [0, 1], near ≈ 1: clip at the 2nd and 98th
    percentile of the subsample, then min-max.  A metric model's depth is
    inverted (1/d over the values d > 0) first; with ten valid values or
    fewer the range is 0."""
    d = raw.float()
    flat = d.reshape(-1)
    if metric:
        valid = flat > 0
        inv_flat = torch.where(valid, 1.0 / flat.clamp_min(1e-12), flat)
        v = _subsample(inv_flat)
        vs = _subsample(valid.to(torch.int32))
        n = v.shape[0]
        sorted_v = torch.sort(torch.where(vs > 0, v, torch.inf)).values
        count = vs.sum()
        tc = torch.clamp(torch.round(PERCENTILE / 100.0 * (count - 1).float())
                         .to(torch.int32) + 1, 1, None)
        tc = torch.minimum(tc, count.clamp_min(1))
        lo = sorted_v[torch.clamp(tc - 1, 0, n - 1)]
        hi = sorted_v[torch.clamp(count - tc, 0, n - 1)]
        few = count <= 10
        lo, hi = torch.where(few, 0.0, lo), torch.where(few, 0.0, hi)
        x = inv_flat.reshape(d.shape)
    else:
        x = d
        v = torch.sort(_subsample(flat)).values
        n = v.shape[0]
        q = max(0.0, min(1.0, PERCENTILE / 100.0))
        tc = min(n, max(1, int(round(q * (n - 1))) + 1))
        lo, hi = (v[0], v[-1]) if tc >= n else (v[tc - 1], v[n - tc])
        if n <= 10:
            lo, hi = torch.zeros_like(lo), torch.zeros_like(hi)
    return torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def foreground_scale(d: torch.Tensor, scale: float, mid: float = 0.5) -> torch.Tensor:
    d = torch.clamp(d, 0.0, 1.0)
    if abs(scale) < 1e-6:
        return d
    dist = d - mid
    return torch.clamp(mid + torch.sign(dist) * torch.abs(dist) ** (1.0 / (1.0 + scale)), 0.0, 1.0)


def gaussian_blur(d: torch.Tensor, strength: float) -> torch.Tensor:
    """Separable Gaussian, k = int(3·strength) | 1, σ = strength / 2, zero padding."""
    k = int(3 * strength) | 1
    if k < 3:
        return d
    coords = np.arange(k, dtype=np.float64) - k // 2
    g = np.exp(-(coords ** 2) / (2.0 * (0.5 * strength) ** 2))
    g = torch.tensor((g / g.sum()).astype(np.float32), device=d.device)
    x = d[None, None]
    x = F.conv2d(x, g.view(1, 1, k, 1), padding=(k // 2, 0))
    x = F.conv2d(x, g.view(1, 1, 1, k), padding=(0, k // 2))
    return x[0, 0]


def display_depth(raw: torch.Tensor, metric: bool, fg_scale: float, aa: float) -> torch.Tensor:
    """Raw model depth [H, W] → display depth [H, W] before the EMA."""
    d = normalize_depth(raw, metric) ** GAMMA
    return gaussian_blur(foreground_scale(d, fg_scale), aa)


def ema_step(prev, depth: torch.Tensor, alpha: float) -> torch.Tensor:
    """The carried EMA after one frame: the frame's depth where there is no
    carry of its shape (the first frame, or a shape change) or the carry is
    NaN, else prev + (1-α)(depth - prev)."""
    if prev is None or prev.shape != depth.shape:
        return depth
    return torch.where(torch.isnan(prev), depth, prev + (1.0 - alpha) * (depth - prev))


def half_sbs(planar: torch.Tensor, depth: torch.Tensor, *, ipd: float, depth_strength: float,
             convergence: float) -> torch.Tensor:
    """Output-size planar rgb [3, oh, ow] and depth at any size → the u8
    Half-SBS frame [oh, ow, 3]."""
    oh, ow = planar.shape[-2:]
    full = F.interpolate(depth[None, None], size=(oh, ow), mode="bilinear",
                         align_corners=False)[0, 0]
    dep_h = (full[:, 0::2] + full[:, 1::2]) * 0.5
    rgb_h = (planar[..., 0::2] + planar[..., 1::2]) * 0.5
    return dibr.half_sbs(rgb_h.contiguous(), dep_h.contiguous(), ipd=ipd,
                         depth_strength=depth_strength, convergence=convergence)
