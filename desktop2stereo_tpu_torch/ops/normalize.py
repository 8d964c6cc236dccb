"""Frame preprocessing helpers: BGRA→RGB, output size, model normalization.

Port of `desktop2stereo_tpu/ops/normalize.py`; NHWC like the JAX package.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HALF_MEAN = (0.5, 0.5, 0.5)
HALF_STD = (0.5, 0.5, 0.5)


def norm_constants(norm_family: str) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    if norm_family == "half":
        return HALF_MEAN, HALF_STD
    if norm_family == "none":
        return (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    return IMAGENET_MEAN, IMAGENET_STD


def process_frame_size(h: int, w: int, target_height: int) -> Tuple[int, int]:
    """Even-aligned aspect-keeping output size."""
    if target_height >= h:
        return h, w
    new_h = (target_height // 2) * 2
    new_w = (int(w * target_height / h) // 2) * 2
    return new_h, new_w


def bgra_to_rgb(frame: torch.Tensor) -> torch.Tensor:
    """[H,W,4] or [H,W,3] BGR(A) uint8 → [H,W,3] RGB (a view)."""
    return frame[..., :3].flip(-1)


@functools.lru_cache(maxsize=16)
def _norm_tables(norm_family: str, dtype: torch.dtype,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, 1/std) on `device`, uploaded once per key: an upload from
    pageable memory waits for the card's queue, so one per frame would hold
    the host back until the previous frame is done.  Made outside inference
    mode, so that tables first built under `torch.inference_mode` also serve
    callers outside it."""
    mean, std = norm_constants(norm_family)
    with torch.inference_mode(False):
        return (torch.tensor(mean, dtype=dtype, device=device),
                torch.tensor([1.0 / s for s in std], dtype=dtype, device=device))


def normalize_for_model(rgb01: torch.Tensor, norm_family: str = "imagenet") -> torch.Tensor:
    """(x - mean)/std with the family's constants; NHWC, x in [0,1]."""
    mean_t, inv_std = _norm_tables(norm_family, rgb01.dtype, rgb01.device)
    return (rgb01 - mean_t) * inv_std
