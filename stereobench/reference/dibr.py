"""A frozen copy of the Half-SBS DIBR plain version: both eyes from planar
rgb [3, eh, ew] (0..255, f32) and depth [eh, ew] in [0, 1], quantized to u8
and laid side by side.

Copied from the program's plain version of its DIBR kernel as it stood
when this benchmark was written, so that a later change to the program's
plain version cannot move the yardstick.  Per pixel: a 3-tap centre depth
smooth and depth shaping, a smoothstep edge falloff, the disocclusion
confidence from the ±2 px depth jump, a forward (depth-weighted) and a
backward (plain) push-pull sweep over the raw depth, ±2-row vertical taps,
then per eye a bilinear warp at the depth-driven position and the
confidence blend.  The multiply-adds that the kernel rounds once are
rounded once here too (`_fma`), so the kernel sits within rounding of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEARCH_RADIUS = 12
DEPTH_TOLERANCE = 0.012
EDGE_MARGIN = 0.05
VSHIFT = 2


def clamp_shift(x: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    """out[i] = x[clamp(i + off)] along `dim` (clamp-to-edge)."""
    if off == 0:
        return x
    n = x.shape[dim]
    idx = (torch.arange(n, device=x.device) + off).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def _smoothstep(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to f32 (the f64 product of f32 operands is exact)."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return float(np.float32(x))
    return (f64(a) * f64(b) + f64(c)).float()


def _edge_coords(idx: torch.Tensor, n: int, scale: float):
    """(u·scale, (1-u)·scale) for u = (idx+0.5)/n, 1/n and `scale` folded
    into one f32 constant and 1-u a fused multiply-add."""
    c = idx + 0.5
    r = np.float32(1.0 / n)
    s = np.float32(scale)
    return c * float(r * s), _fma(-c, r, 1.0) * float(s)


def eyes(rgb: torch.Tensor, d: torch.Tensor, *, ipd: float, depth_strength: float,
         convergence: float):
    """(left, right) planar f32 [3, eh, ew], before quantisation."""
    H, W = d.shape
    h_lo = clamp_shift(d, -2, -1) * 0.5 + clamp_shift(d, -1, -1) * 0.5
    h_hi = clamp_shift(d, 1, -1) * 0.5 + clamp_shift(d, 2, -1) * 0.5
    smooth = _fma(h_hi, 0.15, _fma(d, 0.7, h_lo * 0.15))
    cdi = -smooth
    jump = (clamp_shift(d, -2, -1) - clamp_shift(d, 2, -1)).abs()
    conf_base = _smoothstep(((jump - 0.04) / (0.10 - 0.04)).clamp(0.0, 1.0))
    shaped_conv = _fma(-smooth, _fma(0.35, 1.0 - smooth, 1.0), convergence)

    col = torch.arange(W, dtype=torch.float32, device=d.device).expand(H, W)
    lo, hi = _edge_coords(col, W, np.float32(1.0) / np.float32(EDGE_MARGIN))
    e1 = _smoothstep(lo.clamp(0.0, 1.0))
    e2 = _smoothstep(hi.clamp(0.0, 1.0))
    shift_base = shaped_conv * (depth_strength * (e1 * e2))

    inv_raw = 1.0 - d
    thr = cdi + DEPTH_TOLERANCE
    pre_w = 1.0 - 10.0 * cdi

    def sweep(direction: int, depth_weighted: bool, decay: float):
        acc = torch.zeros_like(rgb)
        wsum = torch.zeros_like(d)
        for t in range(1, SEARCH_RADIUS + 1):
            off = direction * t
            s_inv = clamp_shift(inv_raw, off, -1)
            dist = math.exp(-float(t) * decay)
            if depth_weighted:
                w = dist * pre_w + (10.0 * dist) * s_inv
            else:
                w = torch.full_like(d, dist)
            w = torch.where((s_inv > thr) & (wsum <= 5.0), w, 0.0)
            acc = acc + clamp_shift(rgb, off, -1) * w
            wsum = wsum + w
        return acc, wsum

    fwd_c, fwd_w = sweep(-1, True, 0.15)
    bwd_c, bwd_w = sweep(+1, False, 0.2)

    vadd = torch.zeros_like(rgb)
    vert_w = torch.full_like(d, 0.5)
    for off in (-VSHIFT, VSHIFT):
        w = torch.where((1.0 - clamp_shift(d, off, -2)) > cdi + DEPTH_TOLERANCE * 0.5,
                        0.25, 0.0)
        vadd = vadd + clamp_shift(rgb, off, -2) * w
        vert_w = vert_w + w
    inv_vw = 1.0 / vert_w

    need_bwd = fwd_w < 2.0
    best_w = fwd_w + torch.where(need_bwd, bwd_w, 0.0)
    found = best_w > 0.01
    scale = 0.5 / best_w.clamp_min(1e-12)
    best_c = fwd_c + torch.where(need_bwd, bwd_c, 0.0)
    filled = torch.where(found, (best_c * scale + vadd) * inv_vw, rgb)

    out = []
    for eye in (-abs(ipd / 2.0), abs(ipd / 2.0)):
        disp = float(np.float32(eye) * np.float32(W))
        px = _fma(shift_base, -disp, col)
        oob = (px < 0.0) | (px > W - 1.0)
        pxc = px.clamp(0.0, W - 1.0)
        i0f = torch.floor(pxc)
        frac = pxc - i0f
        i0 = i0f.long()
        i1 = (i0 + 1).clamp_(max=W - 1)
        g0 = torch.gather(rgb, 2, i0.expand(3, H, W))
        g1 = torch.gather(rgb, 2, i1.expand(3, H, W))
        color = g0 * (1.0 - frac) + g1 * frac
        conf = torch.where(oob, 1.0, conf_base)
        out.append(color + conf * (filled - color))
    return out[0], out[1]


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """clip(x + 0.5, 0, 255) truncated to u8."""
    return (x + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def half_sbs(rgb_h: torch.Tensor, dep_h: torch.Tensor, *, ipd: float, depth_strength: float,
             convergence: float) -> torch.Tensor:
    """The finished Half-SBS frame, u8 [eh, 2·ew, 3]."""
    left, right = eyes(rgb_h, dep_h, ipd=ipd, depth_strength=depth_strength,
                       convergence=convergence)
    return torch.cat([quantize_u8(left), quantize_u8(right)], dim=2).permute(1, 2, 0).contiguous()
