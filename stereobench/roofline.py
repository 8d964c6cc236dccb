"""The card's peaks and the operations and bytes of the kernels whose
roofline share the benchmark reports.

The peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), the card
every cell runs on.  A roofline share is the least time the card could
take over the measured time: K2 by its operations over the bf16
tensor-core peak, K1 by its bytes over the HBM bandwidth.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def attention_ops(shapes: Iterable[Tuple[int, int, int, int]]) -> float:
    """Operations of softmax attention calls [B, N, H, d]: q kᵀ and p v,
    2·N²·d each a head, so 4·B·H·N²·d a call."""
    return float(sum(4 * b * h * n * n * d for b, n, h, d in shapes))


def dibr_half_bytes(streams: int, eh: int, ew: int) -> float:
    """K1 on the Half-SBS tail: rgb [S, 3, eh, ew] and depth [S, eh, ew] f32
    read once, the u8 frame [S, eh, 2·ew, 3] written once."""
    return float(streams * (3 * eh * ew * 4 + eh * ew * 4 + eh * 2 * ew * 3))
