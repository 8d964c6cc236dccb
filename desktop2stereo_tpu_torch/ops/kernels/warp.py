"""Horizontal bilinear resample kernel (csrc/warp.cu) and its plain version.

Replaces `desktop2stereo_tpu/ops/pallas/warp.py:horizontal_sample`, the warp
gather of the fast stereo compositor (`ops/stereo.py:_hsample`): each output
pixel samples its own image row at a continuous column `px`, clamp-to-edge.
`img` is [H, W, C] f32, `px` [H, W] f32 already clamped or reflected into
[0, W-1].  No lane-group padding: the second tap clamps to W-1, where the
JAX kernel read a zero pad column with weight 0.
"""

from __future__ import annotations

import ctypes

import torch

from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaLibrary(
    "warp.cu",
    {"d2s_horizontal_sample": [_P, _P, _P, _I, _I, _I, _P]},
    extra_flags=("-fmad=false",),  # the lerp rounds as the plain version's
)


def horizontal_sample_ref(img: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Plain version: out[i, j] = lerp of img[i, x0] and img[i, x0+1] at px[i, j]."""
    W = img.shape[1]
    x0 = torch.floor(px)
    frac = (px - x0)[..., None]
    x0i = x0.long().clamp_(0, W - 1)
    x1i = (x0i + 1).clamp_(max=W - 1)
    C = img.shape[2]
    g0 = torch.gather(img, 1, x0i[..., None].expand(-1, -1, C))
    g1 = torch.gather(img, 1, x1i[..., None].expand(-1, -1, C))
    return g0 * (1.0 - frac) + g1 * frac


def clamp_shift(x: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    """x shifted by a static `off` along `dim`, clamp-to-edge:
    out[i] = x[clamp(i + off)] (the texture reads of every DIBR tap)."""
    if off == 0:
        return x
    n = x.shape[dim]
    idx = (torch.arange(n, device=x.device) + off).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def check_inputs(img: torch.Tensor, px: torch.Tensor) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if img.ndim != 3 or px.shape != img.shape[:2]:
        raise ValueError(f"warp kernel needs img [H,W,C] and px [H,W], got "
                         f"{tuple(img.shape)} and {tuple(px.shape)}")
    for name, t in (("img", img), ("px", px)):
        if t.dtype != torch.float32:
            raise ValueError(f"warp kernel needs f32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"warp kernel needs a contiguous {name}")
    H, W, C = img.shape
    if H == 0 or W == 0 or C == 0 or H > 65535:
        raise ValueError(f"warp kernel: unsupported shape {tuple(img.shape)}")


def horizontal_sample(img: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """[H, W, C] sampled along W at px [H, W].  CPU tensors take
    `horizontal_sample_ref`; CUDA tensors take the kernel or raise."""
    if img.device.type == "cpu" and px.device.type == "cpu":
        check_inputs(img, px)
        return horizontal_sample_ref(img, px)
    if img.device != px.device or img.device.type != "cuda":
        raise ValueError(f"warp: img and px must share one CUDA device (or both "
                         f"be on the CPU), got {img.device}, {px.device}")
    check_inputs(img, px)
    H, W, C = img.shape
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    KERNEL.call("d2s_horizontal_sample", img.data_ptr(), px.data_ptr(),
                out.data_ptr(), H, W, C, stream)
    return out
