"""Model factory: registry name → (model, spec), random weights from a seed.

Port of `desktop2stereo_tpu/models/factory.py:build_bound` for the
depth_anything family.  No checkpoint exists offline, so weights are random,
drawn from a seeded `torch.Generator` with flax's default initializers
(truncated-normal lecun kernels, zero biases, unit LayerNorm and LayerScale,
zero cls/position tables).  Weights from a JAX parameter tree load through
`models/from_flax.py` instead.  `quant="int8"` quantizes the encoder's dense
weights at load (`ops/quant.py:quantize_state_dict`), as the JAX factory's
`quantize_tree` step does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from desktop2stereo_tpu_torch.core.registry import ModelSpec, get_spec
from desktop2stereo_tpu_torch.core.runtime import COMPUTE_DTYPE, cuda_policy
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.dinov2 import PatchEmbed
from desktop2stereo_tpu_torch.models.dpt import ConvTransposeSameStride
from desktop2stereo_tpu_torch.ops.quant import quantize_state_dict

QUANT_MODES = ("none", "int8")

# std of N(0,1) truncated to ±2, the correction flax's truncated_normal
# initializer divides by so the drawn variance is the requested one
_TRUNC_STD = 0.87962566103423978


def _lecun_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded flax-style init of every kernel (biases and tables as built)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _lecun_(m.weight, m.in_features, gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            _lecun_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, PatchEmbed):
            _lecun_(m.weight, m.weight.shape[1], gen)
        elif isinstance(m, ConvTransposeSameStride):
            _lecun_(m.weight, m.weight.shape[0], gen)
    return model


def build_bound(name: str, device: Optional[torch.device | str] = None,
                dtype: Optional[torch.dtype] = None, seed: int = 0,
                quant: str = "none") -> Tuple[DepthAnything, ModelSpec]:
    """Registry name → (eval-mode model on `device` in `dtype`, spec).

    `device=None` is the CUDA device policy's (`cuda_policy()`, which raises
    without CUDA); a caller that wants the CPU says so.  `dtype=None` is the
    policy's compute dtype on a CUDA device and float32 on the CPU.  The
    weights are drawn on the CPU, so one seed gives the same model on every
    device.  `quant="int8"` draws the same float model, quantizes its
    encoder's dense weights in f32 on the CPU and loads them into the int8
    model; its `scale` and `bias` buffers stay f32 in any `dtype`."""
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r} ({'|'.join(QUANT_MODES)})")
    if device is None:
        device = cuda_policy().device
    if dtype is None:
        dtype = COMPUTE_DTYPE if torch.device(device).type == "cuda" else torch.float32
    spec = get_spec(name)
    model = init_random(DepthAnything.from_spec(spec), seed)
    if quant == "int8":
        state = quantize_state_dict(model.state_dict())
        model = DepthAnything.from_spec(spec, quant=True)
        model.load_state_dict(state, strict=True)
    return model.to(device=device, dtype=dtype).eval(), spec
