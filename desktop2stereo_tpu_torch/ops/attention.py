"""Attention entry point of the port, [B, N, H, hd] layout.

Port of `desktop2stereo_tpu/ops/attention.py`.  The JAX package chooses
between its Pallas kernel and XLA by a logits-volume threshold tuned on the
TPU; here there is no threshold: a CUDA tensor always goes to the attention
kernel (csrc/attention.cu) and a CPU tensor to `attention_ref`.  No additive
bias in this slice (BEiT's relative-position bias comes with that family).
"""

from __future__ import annotations

import torch

from desktop2stereo_tpu_torch.ops.kernels.attention import attention, attention_ref

__all__ = ["multi_head_attention", "attention_ref"]


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B,N,H,hd] q/k/v → [B,N,H,hd] softmax(QKᵀ/√hd)·V, non-causal."""
    return attention(q, k, v)
