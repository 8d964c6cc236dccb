"""Depth-Anything V1/V2 / Distill-Any-Depth: DINOv2 encoder + DPT decoder.

Port of `desktop2stereo_tpu/models/depth_anything.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder
from desktop2stereo_tpu_torch.models.dpt import DPTHead, DPTNeck


class DepthAnything(nn.Module):
    """pixels [B,H,W,3] (normalized) → raw depth [B,H,W].  `quant=True`
    builds the int8 encoder (its weights come through `quantize_state_dict`
    or `from_flax` of a quantized JAX tree)."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int,
                 mlp_dim: int, out_layers: Tuple[int, ...],
                 neck_channels: Tuple[int, ...], fusion_channels: int,
                 patch_size: int = 14, metric: bool = False,
                 max_depth: float = 1.0, quant: bool = False) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.patch_size = patch_size
        self.backbone = Dinov2Encoder(hidden_size, num_layers, num_heads, mlp_dim,
                                      out_layers, patch_size=patch_size, quant=quant)
        self.neck = DPTNeck(hidden_size, neck_channels, fusion_channels)
        self.head = DPTHead(fusion_channels, patch_size, metric, max_depth)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "DepthAnything":
        if spec.family != "depth_anything" or spec.variant == "vitg":
            raise NotImplementedError(
                f"{spec.name}: the port builds the depth_anything family up to "
                f"ViT-L (no depth_anything registry name is ViT-G)")
        hidden, layers, heads, mlp = spec.dims
        return cls(hidden_size=hidden, num_layers=layers, num_heads=heads,
                   mlp_dim=mlp, out_layers=spec.dpt_layers,
                   neck_channels=spec.neck_channels,
                   fusion_channels=spec.fusion_channels,
                   patch_size=spec.patch_size, metric=spec.metric,
                   max_depth=spec.max_depth, quant=quant)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = pixels.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        feats = self.backbone(pixels)
        grids = [f[:, 1:].reshape(B, gh, gw, self.hidden_size) for f in feats]
        return self.head(self.neck(grids), (gh, gw))
