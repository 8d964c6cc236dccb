"""Attention entry point of the port, [B, N, H, hd] layout.

Port of `desktop2stereo_tpu/ops/attention.py`.  The JAX package chooses
between its Pallas kernel and XLA by a logits-volume threshold tuned on the
TPU; here there is no threshold: a CUDA tensor always goes to the attention
kernel (csrc/attention.cu) and a CPU tensor to `attention_ref`, with or
without an additive bias (BEiT's relative-position bias, [H, N, N]): the JAX
package sends every biased call to XLA, the port to the kernel's biased
entry point.
"""

from __future__ import annotations

from typing import Optional

import torch

from desktop2stereo_tpu_torch.ops.kernels.attention import attention, attention_ref

__all__ = ["multi_head_attention", "attention_ref"]


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B,N,H,hd] q/k/v → [B,N,H,hd] softmax(QKᵀ/√hd + bias)·V, non-causal;
    `bias` [H,N,N] is shared by the batch."""
    return attention(q, k, v, bias)
