"""Fused int8 dense kernel (csrc/quant_matmul.cu) and its plain version.

Replaces `desktop2stereo_tpu/ops/pallas/quant_matmul.py:quant_dense_matmul`:
per-row dynamic int8 quantisation of the activations, an int8×int8→int32
product with the int8 weight, and the f32 rescale + bias.  One call runs two
device kernels: a row pass that quantises each row of x once into an int8
scratch [M, K] (and its scales into [M]), which stays in L2, then the TMA +
wgmma product with the rescale fused into its epilogue; no int32
intermediate reaches device memory.  The wrapper allocates the scratch.
The weight is stored as `nn.Linear` stores its own, [F, K] with K contiguous
(the JAX tree's `kernel_q` is [K, F]).

Rounding, as XLA compiles the JAX formulation on the CPU (and so as the
interpret-mode kernel and `ops/quant.py:xla_quant_dense` under jit give it):

- the activation scale is `max(|x|, 1e-8) * float32(1/127)`: XLA turns the
  division by the constant 127 into a multiply by its f32 reciprocal;
- the quantised value is `round_half_even(x / s)` (IEEE division), clipped
  to ±127;
- the product is exact (int32 on the card; f64 in the plain version, exact
  since |acc| ≤ 127²·K < 2⁵³);
- the epilogue `acc·(s·scale) + bias` is one fused multiply-add (XLA
  contracts it); with no bias, the plain product.  Then the cast to the
  output type (round-to-nearest-even).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary
from desktop2stereo_tpu_torch.ops.kernels.dibr import _fma

INV_127 = float(np.float32(1.0) / np.float32(127.0))  # the f32 reciprocal XLA folds
K_ALIGN = 32  # the kernel's product takes K in 32-wide steps

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaLibrary("quant_matmul.cu", {
    # x, x_is_bf16, lda, weight_q, scale, bias, row_scale, xq, xs, out, out_kind, M, K, F,
    # stream
    "d2s_quant_dense": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
})
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def activation_scale(absmax: torch.Tensor) -> torch.Tensor:
    """f32 abs-max → the f32 activation scale, max(a, 1e-8)·f32(1/127)."""
    return absmax.clamp_min(1e-8) * INV_127


def quantize_with(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 values and (broadcast) f32 scales → int8, round-half-even, ±127."""
    return torch.round(xf / scale).clamp_(-127.0, 127.0).to(torch.int8)


def dynamic_quantize_rows(x2: torch.Tensor):
    """[M, K] float activations → (int8 [M, K], f32 scales [M, 1]),
    per-row (per-token) abs-max."""
    xf = x2.float()
    scale = activation_scale(xf.abs().amax(dim=-1, keepdim=True))
    return quantize_with(xf, scale), scale


def quant_dense_ref(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    row_scale: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: x [..., K] float, weight_q [F, K] int8, scale [F] f32,
    bias [F] or None, row_scale [..., 1] f32 or None (the per-row scales,
    else computed from x) → [..., F] in `out_dtype` (x.dtype when None);
    `torch.int32` returns the raw accumulators."""
    K = x.shape[-1]
    F = weight_q.shape[0]
    lead = x.shape[:-1]
    if row_scale is None:
        xq, sx = dynamic_quantize_rows(x.reshape(-1, K))
    else:
        sx = row_scale.reshape(-1, 1).float()
        xq = quantize_with(x.reshape(-1, K).float(), sx)
    acc = xq.double() @ weight_q.double().T  # exact: |acc| ≤ 127²·K < 2⁵³
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype == torch.int32:
        return acc.to(torch.int32).reshape(*lead, F)
    rescale = sx * scale.float()[None, :]
    if bias is None:
        out = acc.float() * rescale
    else:
        out = _fma(acc.float(), rescale, bias.float()[None, :])
    return out.to(out_dtype).reshape(*lead, F)


def check_inputs(x2: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], row_scale: Optional[torch.Tensor],
                 out_dtype: torch.dtype) -> None:
    """Raise ValueError for anything the kernel does not take (x2 is x as
    [M, K])."""
    M, K = x2.shape
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_dense kernel needs bf16 or f32 x, got {x2.dtype}")
    if x2.stride(-1) != 1 or x2.stride(0) % (16 // x2.element_size()) or x2.data_ptr() % 16:
        raise ValueError(f"quant_dense kernel needs x with a contiguous, 16-byte aligned "
                         f"last dim, strides {x2.stride()}")
    if weight_q.dtype != torch.int8 or weight_q.ndim != 2 or weight_q.shape[1] != K:
        raise ValueError(f"quant_dense kernel needs int8 weight_q [F, {K}], got "
                         f"{weight_q.dtype} {tuple(weight_q.shape)}")
    if not weight_q.is_contiguous() or weight_q.data_ptr() % 16:
        raise ValueError("quant_dense kernel needs a contiguous, 16-byte aligned weight_q")
    if K == 0 or K % K_ALIGN:
        raise ValueError(f"quant_dense kernel needs K a multiple of {K_ALIGN}, got {K}")
    F = weight_q.shape[0]
    if M == 0 or F == 0 or M > 65535 * 64:
        raise ValueError(f"quant_dense kernel: unsupported shape M={M}, F={F}")
    for name, t, n in (("scale", scale, F), ("bias", bias, F), ("row_scale", row_scale, M)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"quant_dense kernel needs a contiguous f32 {name} of {n} "
                             f"values, got {t.dtype} {tuple(t.shape)}")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"quant_dense kernel writes f32, bf16 or int32, not {out_dtype}")


def quant_dense(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                row_scale: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., K] → [..., F], arguments as `quant_dense_ref`.  CPU tensors
    take `quant_dense_ref`; CUDA tensors take the kernel or raise."""
    tensors = [t for t in (x, weight_q, scale, bias, row_scale) if t is not None]
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return quant_dense_ref(x, weight_q, scale, bias, row_scale, out_dtype)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"quant_dense: every tensor must be on one CUDA device (or "
                         f"all on the CPU), got {sorted(map(str, devices))}")
    K = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    rs = None if row_scale is None else row_scale.reshape(-1)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    check_inputs(x2, weight_q, scale, bias, rs, out_dtype)
    M, F = x2.shape[0], weight_q.shape[0]
    out = torch.empty((M, F), dtype=out_dtype, device=x.device)
    # the row pass's scratch, one allocation: q [M, K] int8, then the f32
    # scales [M] (M·K is a multiple of 32, so they are aligned)
    scratch = torch.empty(M * K + 4 * M, dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.call("d2s_quant_dense", x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                x2.stride(0), weight_q.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(),
                None if rs is None else rs.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + M * K, out.data_ptr(), _OUT_KIND[out_dtype], M, K, F,
                stream)
    return out.reshape(*lead, F)
