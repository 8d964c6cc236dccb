"""Depth post-processing: percentile normalize → gamma → foreground scale →
anti-alias, and the temporal EMA.

Port of `desktop2stereo_tpu/ops/depth_post.py`.  Static shapes as there: the
metric path's valid-mask reduction uses an inf-ranked sort, so nothing here
synchronises with the host.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

PERCENTILE = 2.0
SUBSAMPLE_CAP = 6_144


def _tail_count(n: int, percentile: float) -> int:
    lo_q = max(0.0, min(1.0, percentile / 100.0))
    return min(n, max(1, int(round(lo_q * (n - 1))) + 1))


def _subsample(flat: torch.Tensor, cap: int = SUBSAMPLE_CAP) -> torch.Tensor:
    n = flat.shape[0]
    if n <= cap:
        return flat
    return flat[:: (n + cap - 1) // cap]


def normalize_depth(depth: torch.Tensor, metric: bool = False,
                    percentile: float = PERCENTILE,
                    subsample_cap: int = SUBSAMPLE_CAP) -> torch.Tensor:
    """Raw model output → [0,1], near≈1 / far≈0 (percentile clip + min-max;
    metric models invert 1/d over the valid d>0 values first)."""
    d = depth.float().squeeze()
    flat = d.reshape(-1)
    if metric:
        valid = flat > 0
        inv_flat = torch.where(valid, 1.0 / flat.clamp_min(1e-12), flat)
        v = _subsample(inv_flat, subsample_cap)
        valid_s = _subsample(valid.to(torch.int32), subsample_cap)
        n = v.shape[0]
        sorted_v = torch.sort(torch.where(valid_s > 0, v, torch.inf)).values
        count = valid_s.sum()
        tc = torch.clamp(torch.round(percentile / 100.0 * (count - 1).float())
                         .to(torch.int32) + 1, 1, None)
        tc = torch.minimum(tc, count.clamp_min(1))
        # picked on the device: indexing with a 0-dim tensor reads it on the host
        lo = sorted_v.index_select(0, torch.clamp(tc - 1, 0, n - 1).reshape(1)).reshape(())
        hi = sorted_v.index_select(0, torch.clamp(count - tc, 0, n - 1).reshape(1)).reshape(())
        few = count <= 10
        lo = torch.where(few, 0.0, lo)
        hi = torch.where(few, 0.0, hi)
        inv = inv_flat.reshape(d.shape)
    else:
        inv = d
        v = torch.sort(_subsample(flat, subsample_cap)).values
        n = v.shape[0]
        tc = _tail_count(n, percentile)
        lo, hi = (v[0], v[-1]) if tc >= n else (v[tc - 1], v[n - tc])
        if n <= 10:
            lo, hi = torch.zeros_like(lo), torch.zeros_like(hi)
    denom = torch.clamp(hi - lo, min=1e-6)
    return torch.clamp((inv - lo) / denom, 0.0, 1.0)


def apply_gamma(depth01: torch.Tensor, gamma: float = 1.45) -> torch.Tensor:
    return torch.pow(depth01, gamma)


def apply_foreground_scale(depth01: torch.Tensor, scale: float, mid: float = 0.5,
                           eps: float = 1e-6) -> torch.Tensor:
    """Power-curve contrast around `mid`."""
    if not (-1.0 + 1e-12 < scale):
        raise ValueError("scale must be greater than -1.0")
    d = torch.clamp(depth01, 0.0, 1.0)
    if abs(scale) < eps:
        return d
    dist = d - mid
    out = mid + torch.sign(dist) * torch.pow(torch.abs(dist), 1.0 / (1.0 + scale))
    return torch.clamp(out, 0.0, 1.0)


@functools.lru_cache(maxsize=32)
def _gauss_kernel(k: int, sigma: float) -> np.ndarray:
    coords = np.arange(k, dtype=np.float64) - k // 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def anti_alias(depth: torch.Tensor, strength: float = 1.0) -> torch.Tensor:
    """Separable Gaussian, k = int(3·strength)|1, zero ('same') padding —
    torch conv2d's border behaviour, as the JAX package matches it."""
    k = int(3 * strength) | 1
    if k < 3:
        return depth
    g = _gauss_kernel(k, 0.5 * strength)
    r = k // 2
    x = depth
    for axis in (0, 1):
        pad = (0, 0, r, r) if axis == 0 else (r, r)
        xp = F.pad(x, pad)
        acc = None
        for i in range(k):
            term = xp.narrow(axis, i, x.shape[axis]) * float(g[i])
            acc = term if acc is None else acc + term
        x = acc
    return x


def ema(prev: Optional[torch.Tensor], depth: torch.Tensor, alpha: float = 0.9) -> torch.Tensor:
    """prev.lerp(depth, 1-α); `prev is None` passes depth through."""
    if prev is None:
        return depth
    return prev + (1.0 - alpha) * (depth - prev)


def post_process_depth(depth_raw: torch.Tensor, metric: bool = False,
                       gamma: float = 1.45, foreground_scale: float = 0.0,
                       aa_strength: float = 1.0) -> torch.Tensor:
    """Full chain minus EMA."""
    d = normalize_depth(depth_raw, metric=metric)
    d = apply_gamma(d, gamma)
    d = apply_foreground_scale(d, foreground_scale)
    return anti_alias(d, aa_strength)
