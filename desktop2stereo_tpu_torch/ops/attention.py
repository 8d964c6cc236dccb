"""Attention entry point of the port, [B, N, H, hd] layout.

Port of `desktop2stereo_tpu/ops/attention.py`.  The JAX package chooses
between its Pallas kernel and XLA by a logits-volume threshold tuned on the
TPU; here there is no threshold: a CUDA tensor always goes to the attention
kernel (csrc/attention.cu) and a CPU tensor to its plain version.  An
additive bias comes in one of two forms: a dense [H, N, N] `bias` (the JAX
package's hook, which sends every biased call to XLA; here the kernel's
dense entry), or BEiT's relative-position bias as `rel_pos=(table, gh, gw)`,
one layer's [H, R] table for a gh × gw grid, which the kernel's table entry
gathers itself, so that no [H, N, N] tensor exists.  The relative-position
index helpers live here too, one copy for the plain version and the model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from desktop2stereo_tpu_torch.ops.kernels.attention import (
    _relative_position_index, attention, attention_ref, attention_relpos, attention_relpos_ref,
    expand_rel_pos, relative_position_count)

__all__ = ["multi_head_attention", "attention_ref", "attention_relpos_ref", "expand_rel_pos",
           "relative_position_count", "_relative_position_index"]


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         rel_pos: Optional[Tuple[torch.Tensor, int, int]] = None
                         ) -> torch.Tensor:
    """[B,N,H,hd] q/k/v → [B,N,H,hd] softmax(QKᵀ/√hd + bias)·V, non-causal;
    the bias, shared by the batch, is `bias` [H,N,N] or, from a table,
    `rel_pos=(table [H, R], gh, gw)`."""
    if rel_pos is not None:
        if bias is not None:
            raise ValueError("multi_head_attention takes a bias or rel_pos, not both")
        return attention_relpos(q, k, v, *rel_pos)
    return attention(q, k, v, bias)
