"""Single-eye DIBR kernel (csrc/dibr_fill.cu) and its plain version.

Replaces `desktop2stereo_tpu/ops/pallas/dibr.py:dibr_warp_fill_blend`, the
body of the per-eye `ops/stereo.py:dibr_render`: the bilinear colour warp at
a given position, the directional push-pull background inpaint over RAW
depth (a depth-weighted sweep, then the plain opposite sweep where it found
little), the ±2-row vertical blur, and the confidence blend.  Inputs
are rgb [H, W, 3] f32 (0..255), RAW depth, the disocclusion confidence and
the warp position px (clamped to [0, W-1]), each [H, W] f32.  No edge or
tile padding: clamp-to-edge reads on the true frame equal the JAX kernel's
reads of its edge-padded frame.  The kernel shares K1's row-segment design
and its launch geometry (`dibr.py:tile_geometry`, halo ≥ the radius).
"""

from __future__ import annotations

import ctypes
import math

import torch

from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary
from desktop2stereo_tpu_torch.ops.kernels.dibr import TileGeometry, tile_geometry
from desktop2stereo_tpu_torch.ops.kernels.warp import clamp_shift, horizontal_sample_ref

MAX_SEARCH_RADIUS = 32  # the kernel's weight tables
VSHIFT = 2              # vertical blur tap distance (rows)
# pixels a block aims at (dibr.tile_geometry): whole 4K rows (93 KB, two
# blocks an SM) ran 41% slower than 512-pixel segments (PERF.md)
SEG_TARGET = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaLibrary(
    "dibr_fill.cu",
    {"d2s_dibr_warp_fill_blend": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  ctypes.c_double, *[_I] * len(TileGeometry._fields),
                                  _P]},
    # no contracted multiply-adds: the tap and threshold decisions round as
    # in the plain version, whose every op rounds on its own
    extra_flags=("-fmad=false",),
)


def dibr_warp_fill_blend_ref(rgb: torch.Tensor, depth: torch.Tensor,
                             conf: torch.Tensor, px: torch.Tensor, *,
                             sweep_sign: float = 1.0, search_radius: int = 12,
                             depth_tolerance: float = 0.012) -> torch.Tensor:
    """Plain version, in the JAX kernel's operation order: [H, W, 3] f32."""
    color = horizontal_sample_ref(rgb, px)
    d = depth
    # the symmetric 3-tap centre smooth at ±1.5 px, from RAW depth
    htap = ((clamp_shift(d, 1, 1) * 0.5 + clamp_shift(d, 2, 1) * 0.5)
            + (clamp_shift(d, -1, 1) * 0.5 + clamp_shift(d, -2, 1) * 0.5))
    cdi = -(d * 0.7 + htap * 0.15)

    def sweep(direction: float, decay: float, depth_weighted: bool):
        acc = torch.zeros_like(rgb)
        wsum = torch.zeros_like(d)  # doubles as the reference's cum-gate
        for t in range(1, search_radius + 1):
            off = int(direction * t)
            s_inv = 1.0 - clamp_shift(d, off, 1)
            dist = math.exp(-float(t) * decay)
            if depth_weighted:
                w = dist * (1.0 + (s_inv - cdi) * 10.0)
            else:
                w = torch.full_like(d, dist)
            w = torch.where((s_inv > cdi + depth_tolerance) & (wsum <= 5.0), w, 0.0)
            acc = acc + clamp_shift(rgb, off, 1) * w[..., None]
            wsum = wsum + w
        return acc, wsum

    fwd_c, fwd_w = sweep(sweep_sign, 0.15, True)
    bwd_c, bwd_w = sweep(-sweep_sign, 0.2, False)
    need_bwd = fwd_w < 2.0
    best_c = fwd_c + torch.where(need_bwd[..., None], bwd_c, 0.0)
    best_w = fwd_w + torch.where(need_bwd, bwd_w, 0.0)
    found = best_w > 0.01
    inv_w = 1.0 / best_w.clamp_min(1e-12)
    vert_c = (best_c * inv_w[..., None]) * 0.5
    vert_w = torch.full_like(d, 0.5)
    for off in (-VSHIFT, VSHIFT):
        ok = (1.0 - clamp_shift(d, off, 0)) > cdi + depth_tolerance * 0.5
        w = torch.where(ok, 0.25, 0.0)
        vert_c = vert_c + clamp_shift(rgb, off, 0) * w[..., None]
        vert_w = vert_w + w
    filled = torch.where(found[..., None], vert_c * (1.0 / vert_w)[..., None], rgb)
    return color + conf[..., None] * (filled - color)


def check_inputs(rgb: torch.Tensor, depth: torch.Tensor, conf: torch.Tensor,
                 px: torch.Tensor, sweep_sign: float, search_radius: int) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if rgb.ndim != 3 or rgb.shape[2] != 3 or any(
            t.shape != rgb.shape[:2] for t in (depth, conf, px)):
        raise ValueError(f"dibr_fill kernel needs rgb [H,W,3] and depth, conf, px "
                         f"[H,W], got {tuple(rgb.shape)}, {tuple(depth.shape)}, "
                         f"{tuple(conf.shape)}, {tuple(px.shape)}")
    for name, t in (("rgb", rgb), ("depth", depth), ("conf", conf), ("px", px)):
        if t.dtype != torch.float32:
            raise ValueError(f"dibr_fill kernel needs f32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dibr_fill kernel needs a contiguous {name}")
    H, W = depth.shape
    if H == 0 or W == 0 or H > 65535:
        raise ValueError(f"dibr_fill kernel: unsupported frame {H}x{W}")
    if not 0 <= search_radius <= MAX_SEARCH_RADIUS:
        raise ValueError(f"dibr_fill kernel: search_radius {search_radius}, at most "
                         f"{MAX_SEARCH_RADIUS}")
    if abs(sweep_sign) != 1.0:
        raise ValueError(f"dibr_fill kernel: sweep_sign must be +1 or -1, got {sweep_sign}")


def dibr_warp_fill_blend(rgb: torch.Tensor, depth: torch.Tensor, conf: torch.Tensor,
                         px: torch.Tensor, *, sweep_sign: float = 1.0,
                         search_radius: int = 12,
                         depth_tolerance: float = 0.012) -> torch.Tensor:
    """One eye → [H, W, 3] f32.  CPU tensors take `dibr_warp_fill_blend_ref`;
    CUDA tensors take the kernel or raise."""
    kw = dict(sweep_sign=sweep_sign, search_radius=search_radius,
              depth_tolerance=depth_tolerance)
    tensors = (rgb, depth, conf, px)
    check_inputs(*tensors, sweep_sign, search_radius)
    if all(t.device.type == "cpu" for t in tensors):
        return dibr_warp_fill_blend_ref(*tensors, **kw)
    if any(t.device != rgb.device for t in tensors) or rgb.device.type != "cuda":
        raise ValueError("dibr_fill: rgb, depth, conf and px must share one CUDA "
                         "device (or all be on the CPU), got "
                         + ", ".join(str(t.device) for t in tensors))
    H, W = depth.shape
    out = torch.empty_like(rgb)
    stream = torch.cuda.current_stream(rgb.device).cuda_stream
    KERNEL.call("d2s_dibr_warp_fill_blend", rgb.data_ptr(), depth.data_ptr(),
                conf.data_ptr(), px.data_ptr(), out.data_ptr(), H, W,
                1 if sweep_sign > 0 else -1, search_radius, float(depth_tolerance),
                *tile_geometry(W, search_radius, SEG_TARGET), stream)
    return out
