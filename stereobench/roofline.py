"""The card's peaks and the operations and bytes of the kernels whose
roofline share the benchmark reports.

The peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), the card
every cell runs on.  A roofline share is the least time the card could
take over the measured time: K2 by its operations over the bf16
tensor-core peak, K1 by its bytes over the HBM bandwidth.

A streaming model's temporal modules (Video-Depth-Anything's) are counted
by the work one step needs, whatever implements it: each window entry's K
and V are projected once, when the entry is made, not again in every step
it stays in the window, and the window is read once and one entry written
a site.
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


def temporal_ops(shapes: Iterable[Tuple[int, int, int, int]], blocks: int = 2,
                 ff_mult: int = 4) -> float:
    """Operations of one streaming step of temporal modules (B, P, n, C): B
    feeds, P pixels, a window of n frames with this one, C channels.  A
    pixel's sequence: proj_in (2·C²); in each of `blocks` attention blocks
    the new frame's q, k, v and the output projection (4 × 2·C²), and q·kᵀ
    and p·v over the n frames (2 × 2·n·C); a GEGLU feed-forward of
    `ff_mult`·C (2·C·2·ff_mult·C + 2·ff_mult·C·C); proj_out (2·C²)."""
    return float(sum(b * p * ((4 + 8 * blocks + 6 * ff_mult) * c * c + 4 * blocks * n * c)
                     for b, p, n, c in shapes))


def window_bytes(shapes: Iterable[Tuple[int, int, int, int]], dtype_bytes: int,
                 blocks: int = 2) -> float:
    """Bytes of the temporal modules' windows in one streaming step: at each
    of a module's `blocks` sites, the n − 1 carried entries [B, P, C] read
    once and the new one written once, in the configuration's dtype."""
    return float(sum(blocks * b * p * n * c * dtype_bytes for b, p, n, c in shapes))
