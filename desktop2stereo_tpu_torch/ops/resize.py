"""Separable resizes as dense weight-matrix matmuls (torch F.interpolate parity).

Port of `desktop2stereo_tpu/ops/resize.py`.  `resize_weights` builds the same
[out, in] numpy tables (float64 math, float32 result) as the JAX package;
`resize` applies them along H then W with `torch.matmul` (an integer
"area" downscale as a block mean).  Layout follows the
JAX package: NHWC / HWC / HW, spatial axes at ndim-3 and ndim-2 (HW for 2-D).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["resize", "resize_weights", "resize_halved", "patch_aligned_size",
           "resize_patch_aligned"]


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel (a=-0.75 plain, -0.5 antialiased)."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=256)
def resize_weights(
    in_size: int,
    out_size: int,
    mode: str = "bilinear",
    align_corners: bool = False,
    antialias: bool = False,
    scale_override: Optional[float] = None,
) -> np.ndarray:
    """[out_size, in_size] float32 row matrix replicating torch F.interpolate.

    Modes: "bilinear", "bicubic", "area" (the JAX package's "nearest" comes
    with the path that uses it).  Clamp-to-edge borders; antialias windows
    truncate at the edge and renormalize (aten's AA path).  `scale_override`
    samples at src = dst / scale, as torch's scale_factor calls do where the
    scale differs from out/in (DINOv2's `interpolate_offset` position
    table).
    """
    if in_size == out_size and mode != "area" and scale_override is None:
        return np.eye(out_size, dtype=np.float32)

    W = np.zeros((out_size, in_size), dtype=np.float64)

    if mode == "area":
        # F.interpolate(mode="area") == adaptive average pooling: output i
        # averages the inputs in [floor(i·in/out), ceil((i+1)·in/out))
        for i in range(out_size):
            start = (i * in_size) // out_size
            end = -(-((i + 1) * in_size) // out_size)
            W[i, start:end] = 1.0 / (end - start)
        return W.astype(np.float32)

    if mode == "bilinear":
        support, kernel = 1.0, _triangle_kernel
    elif mode == "bicubic":
        support = 2.0
        a = -0.5 if antialias else -0.75
        kernel = lambda x: _cubic_kernel(x, a)  # noqa: E731
    else:
        raise ValueError(f"unsupported resize mode {mode!r}")

    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        centers = np.arange(out_size) * scale
        kscale = 1.0
    else:
        scale = (1.0 / scale_override) if scale_override else in_size / out_size
        centers = (np.arange(out_size) + 0.5) * scale - 0.5
        kscale = max(scale, 1.0) if antialias else 1.0

    radius = support * kscale
    for i in range(out_size):
        c = centers[i]
        if antialias:
            lo = max(0, int(c + 0.5 - radius + 0.5))
            hi = min(in_size, int(c + 0.5 + radius + 0.5))
            taps = np.arange(lo, hi)
            w = kernel((taps - c) / kscale)
            s = w.sum()
            if s != 0.0:
                w = w / s
            W[i, lo:hi] = w
        else:
            lo = int(math.floor(c)) - int(support) + 1
            taps = np.arange(lo, lo + int(2 * support))
            w = kernel(taps - c)
            s = w.sum()
            if s != 0.0:
                w = w / s
            np.add.at(W[i], np.clip(taps, 0, in_size - 1), w)

    return W.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _table(n_in: int, n_out: int, mode: str, align_corners: bool,
           antialias: bool, halved: bool,
           device: torch.device, dtype: torch.dtype,
           scale_override: Optional[float] = None) -> torch.Tensor:
    """A resize table as a tensor on `device`, uploaded once per key (the 4K
    tables are several MB; re-uploading them every frame would be an H2D
    copy per resize).  Made outside inference mode, so that a table first
    built under `torch.inference_mode` also serves callers outside it."""
    w = resize_weights(n_in, n_out, mode, align_corners, antialias, scale_override)
    if halved:
        w = 0.5 * (w[0::2] + w[1::2])  # fold the pair-mean into the table
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device, dtype)


def _apply_1d(x: torch.Tensor, w: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract `axis` of x with the [out, in] table as one (batched) GEMM.

    The axes before `axis` become the batch (or the rows) and the axes after
    it the columns, so no axis is moved and no copy is made.  Moving the
    axis last instead would, with the trailing singleton channel the planar
    and depth paths carry, make torch.matmul run one matrix-vector product
    per row (cuBLAS gemv, ~2 ms per 4K resize on an H100)."""
    shape = x.shape
    pre, n, post = math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:])
    if post == 1:
        y = x.reshape(pre, n) @ w.t()
    else:
        y = torch.matmul(w, x.reshape(pre, n, post))
    return y.reshape(*shape[:axis], w.shape[0], *shape[axis + 1:])


def resize(
    x: torch.Tensor,
    size: Tuple[int, int],
    mode: str = "bilinear",
    align_corners: bool = False,
    antialias: bool = False,
    scale_override: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Resize NHWC / HWC / HW to `size` (H, W) with F.interpolate semantics;
    `scale_override` = (sh, sw) replicates a scale_factor call.

    An "area" downscale by an integer factor is a block mean, computed as a
    reshape and a sum instead of the dense table: each table row holds 1/f
    on f adjacent inputs, and for the factor 2 of the Half modes
    (a + b) / 2 rounds exactly as 0.5·a + 0.5·b.  At 4K the dense table
    would be [3840, 7680] f32 (118 MB) and ~0.4 TFLOP a frame."""
    h_axis = x.ndim - 3 if x.ndim >= 3 else 0
    scales = scale_override or (None, None)
    if tuple(x.shape[h_axis:h_axis + 2]) == tuple(size) and scale_override is None:
        return x
    if not x.is_floating_point():
        x = x.float()
    for axis, n_out, sc in ((h_axis, size[0], scales[0]), (h_axis + 1, size[1], scales[1])):
        n_in = x.shape[axis]
        if n_in == n_out and sc is None:
            continue
        if mode == "area" and n_in % n_out == 0 and sc is None:
            f = n_in // n_out
            x = x.unflatten(axis, (n_out, f)).sum(axis + 1) / f
        else:
            w = _table(n_in, n_out, mode, align_corners, antialias, False,
                       x.device, x.dtype, sc)
            x = _apply_1d(x, w, axis)
    return x


def resize_halved(
    x: torch.Tensor,
    full_size: Tuple[int, int],
    halve_axis: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """pair-mean-halve(resize(x, full_size)) as one composed table on the
    halved axis: the Half-SBS/TAB tail's depth path (halve_axis 0 = H for
    Half-TAB, 1 = W for Half-SBS).  The full size on that axis must be even."""
    h_axis = x.ndim - 3 if x.ndim >= 3 else 0
    axes = tuple(full_size)
    if axes[halve_axis] % 2:
        raise ValueError(f"resize_halved needs an even size on axis "
                         f"{halve_axis}, got {full_size}")
    for ax_rel in (0, 1):
        axis = h_axis + ax_rel
        n_in, n_out = x.shape[axis], axes[ax_rel]
        if ax_rel == halve_axis:
            w = _table(n_in, n_out, mode, False, False, True, x.device, x.dtype)
            x = _apply_1d(x, w, axis)
        elif n_in != n_out:
            w = _table(n_in, n_out, mode, False, False, False, x.device, x.dtype)
            x = _apply_1d(x, w, axis)
    return x


def patch_aligned_size(h: int, w: int, target: int, patch: int) -> Tuple[int, int]:
    """Longest side → target, each dim snapped to the nearest patch multiple."""
    longest = max(h, w)
    scale = target / float(longest) if longest != target else 1.0
    sh = max(1, int(round(h * scale)))
    sw = max(1, int(round(w * scale)))

    def nearest_multiple(v: int, p: int) -> int:
        down = (v // p) * p
        up = down + p
        return up if abs(up - v) <= abs(v - down) else down

    return max(patch, nearest_multiple(sh, patch)), max(patch, nearest_multiple(sw, patch))


def resize_patch_aligned(x: torch.Tensor, target: int, patch: int,
                         antialias: bool = True) -> torch.Tensor:
    """Aspect-preserving longest-side resize to `target`, each side snapped
    to the patch grid, in one bicubic pass (antialiased, the reference's
    CUDA path); NHWC / HWC.  `x` unchanged where the size already fits."""
    h, w = x.shape[-3], x.shape[-2]
    nh, nw = patch_aligned_size(h, w, target, patch)
    if (nh, nw) == (h, w):
        return x
    return resize(x, (nh, nw), mode="bicubic", antialias=antialias)
