"""Attention kernel (csrc/attention.cu) and its plain version.

Replaces `desktop2stereo_tpu/ops/pallas/flash_attention.py:flash_attention`.
Layout [B, N, H, hd] as in the JAX package.  The kernel takes bf16 q/k/v with
hd = 64, a contiguous head dim and 16-byte aligned rows, reading q/k/v
through their strides by TMA (the views of a fused qkv projection need no
copy), and returns a fresh contiguous bf16 [B, N, H, 64].  An additive bias
(BEiT's relative-position bias) is a contiguous [H, N, N] tensor in bf16 or
f32, shared by the batch, added to the scaled logits before the softmax; it
goes through the kernel's biased entry point.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary

HEAD_DIM = 64

BIAS_DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_QKV = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float]
KERNEL = CudaLibrary("attention.cu", {
    "d2s_attention_fwd": _QKV + [_P],
    "d2s_attention_bias_fwd": _QKV + [_P, _I, _P],
})


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax(QKᵀ/√hd + bias)·V over materialised f32 logits; the
    counterpart of `desktop2stereo_tpu/ops/attention.py:xla_attention`
    (`bias` [H, N, N] added in f32 to the scaled logits; probabilities are
    cast to q's dtype before the P·V product, output in q's dtype)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v.to(q.dtype))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention kernel needs equal [B,N,H,hd] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"attention kernel needs head dim {HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    B, N, H, _ = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        sb, sn, sh, sd = t.stride()
        if t.dtype != torch.bfloat16:
            raise ValueError(f"attention kernel needs bf16 {name}, got {t.dtype}")
        if sd != 1:
            raise ValueError(f"attention kernel needs a contiguous head dim "
                             f"for {name}, strides {t.stride()}")
        if (sb | sn | sh) % 8 or t.data_ptr() % 16:
            raise ValueError(f"attention kernel needs 16-byte aligned rows for "
                             f"{name}: strides {t.stride()}, ptr {t.data_ptr()}")
        if (sb == 0 < B - 1) or (sn == 0 < N - 1) or (sh == 0 < H - 1):
            raise ValueError(f"attention kernel needs distinct rows for {name} (a TMA "
                             f"tensor map takes no zero stride): strides {t.stride()}")
    if q.shape[1] == 0 or q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"attention kernel: unsupported shape {tuple(q.shape)}")
    if bias is not None:
        if tuple(bias.shape) != (H, N, N):
            raise ValueError(f"attention kernel needs a [H, N, N] = {[H, N, N]} bias, got "
                             f"{tuple(bias.shape)}")
        if bias.dtype not in BIAS_DTYPES:
            raise ValueError(f"attention kernel needs a bf16 or f32 bias, got {bias.dtype}")
        if not bias.is_contiguous() or bias.data_ptr() % 16:
            raise ValueError(f"attention kernel needs a contiguous, 16-byte aligned bias: "
                             f"strides {bias.stride()}, ptr {bias.data_ptr()}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B,N,H,hd] (+ bias [H,N,N]) → [B,N,H,hd].  CPU tensors take
    `attention_ref`; CUDA tensors take the kernel or raise."""
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return attention_ref(q, k, v, bias)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"attention: q/k/v (and bias) must share one CUDA device (or "
                         f"all be on the CPU), got {sorted(map(str, devices))}")
    check_inputs(q, k, v, bias)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(D))
    if bias is None:
        KERNEL.call("d2s_attention_fwd", *args, stream)
    else:
        KERNEL.call("d2s_attention_bias_fwd", *args, bias.data_ptr(),
                    int(bias.dtype == torch.float32), stream)
    return out
