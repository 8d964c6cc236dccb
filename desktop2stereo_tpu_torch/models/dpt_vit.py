"""Classic DPT (MiDaS v3 / Intel dpt-large family): a plain ViT backbone and
the readout-project DPT decoder, and DPT-DINOv2 (a DINOv2 trunk on the same
decoder).

Port of `desktop2stereo_tpu/models/dpt_vit.py`.  Against the
Depth-Anything decoder (`models/dpt.py:DPTNeck` / `DPTHead`):

- the neck takes whole token sequences, cls first: each stage concatenates
  every patch token with the cls token and projects them back,
  Linear(2D → D) + GELU (the readout projection);
- the fusion chain upsamples a fixed ×2 (align_corners=True) and resizes a
  lateral input of another size to the fused map (align_corners=False);
- the head upsamples ×2 between its convs and returns depth at its own
  resolution, 32·⌈g/2⌉ pixels a side for a grid of g patches (16·g on an
  even grid, whatever the patch size): the frame program's upsample to the
  output takes it as it is (`pipeline/programs.py`).

DPTViT's position table holds 24² + 1 entries (384 / 16) and is resized
bilinearly (align_corners=False) on any other grid, as HF DPT's
`_resize_pos_embed`.  DPTDinov2 is facebook/dpt-dinov2-*: the DINOv2
trunk's last four hidden states, final-layernormed and with the cls token,
feed the readout neck; ViT-G runs the SwiGLU MLP, as the published giant
checkpoints do.  Module and parameter names follow the JAX tree.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder, _dense, patch_vectors
from desktop2stereo_tpu_torch.models.dpt import (
    HEAD_CHANNELS, REASSEMBLE_FACTORS, Conv, FeatureFusionLayer, ReassembleLayer)
from desktop2stereo_tpu_torch.ops.activations import gelu
from desktop2stereo_tpu_torch.ops.attention import multi_head_attention
from desktop2stereo_tpu_torch.ops.resize import resize

# HF DPTConfig presets: variant → (hidden, layers, heads, mlp, out_indices)
DPT_VIT_PRESETS = {
    "vitb": (768, 12, 12, 3072, (2, 5, 8, 11)),
    "vitl": (1024, 24, 16, 4096, (5, 11, 17, 23)),
}
VIT_LN_EPS = 1e-12


def patch_tokens(pixels: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 patch: int) -> torch.Tensor:
    """Conv2d(3, D, k=p, s=p) as one product: [B,H,W,C] → [B, gh·gw, D], the
    patch vectors against `kernel` [p·p·C, D] (the flax tree's layout)."""
    x = patch_vectors(pixels, patch)
    return F.linear(x, kernel.t().to(x.dtype), bias.to(x.dtype))


def position_table(pos: torch.Tensor, gh: int, gw: int, pretrain_grid: int) -> torch.Tensor:
    """[1, M²+1, D] table → [1, gh·gw+1, D]: the patch entries resized
    bilinearly in f32 (align_corners=False) when the grid is not M × M."""
    M = pretrain_grid
    if (gh, gw) == (M, M):
        return pos
    D = pos.shape[-1]
    grid = resize(pos[0, 1:].reshape(M, M, D).float(), (gh, gw), mode="bilinear")
    return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, D).to(pos.dtype)], dim=1)


def readout_grid(f: torch.Tensor, readout: nn.Module, gh: int, gw: int) -> torch.Tensor:
    """Token sequence [B, 1+N, D], cls first → [B, gh, gw, D]: every patch
    token concatenated with the cls token, projected back to D, GELU."""
    cls_tok, tokens = f[:, :1], f[:, 1:]
    merged = torch.cat([tokens, cls_tok.expand_as(tokens)], dim=-1)
    return gelu(readout(merged)).reshape(f.shape[0], gh, gw, -1)


def fuse(stages: Sequence[torch.Tensor], fusion: nn.ModuleList) -> list:
    """The ×2 fusion chain, coarsest stage first; every step's output."""
    fused, out = None, []
    for s, layer in zip(stages[::-1], fusion):
        fused = layer(s) if fused is None else layer(fused, s)
        out.append(fused)
    return out


def classic_head(m: nn.Module, fused: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`m.head_conv1` → ×2 (align_corners=True) → `head_conv2` + ReLU →
    `head_conv3` + ReLU: (depth [B, 2h, 2w], the mid features)."""
    h = m.head_conv1(fused)
    h = resize(h, (h.shape[1] * 2, h.shape[2] * 2), mode="bilinear", align_corners=True)
    feat_mid = F.relu(m.head_conv2(h))
    return F.relu(m.head_conv3(feat_mid))[..., 0], feat_mid


def with_cls(tokens: torch.Tensor, cls: torch.Tensor,
             pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cls token first, then the patch tokens; plus the position table."""
    B, _, D = tokens.shape
    x = torch.cat([cls.expand(B, 1, D).to(tokens.dtype), tokens], dim=1)
    return x if pos is None else x + pos.to(tokens.dtype)


class ViTLayer(nn.Module):
    """HF ViT block: pre-norm (eps 1e-12), fused qkv, no LayerScale."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 quant: bool = False) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(hidden_size, eps=VIT_LN_EPS)
        self.qkv = _dense(hidden_size, 3 * hidden_size, quant)
        self.proj = _dense(hidden_size, hidden_size, quant)
        self.norm2 = nn.LayerNorm(hidden_size, eps=VIT_LN_EPS)
        self.fc1 = _dense(hidden_size, mlp_dim, quant)
        self.fc2 = _dense(mlp_dim, hidden_size, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        hd = D // self.num_heads
        q, k, v = (t.unflatten(-1, (self.num_heads, hd))
                   for t in self.qkv(self.norm1(x)).split(D, dim=-1))
        x = x + self.proj(multi_head_attention(q, k, v).reshape(B, N, D))
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class ClassicDPTDecoder(nn.Module):
    """Readout-project reassemble → 3x3 convs → ×2 fusion chain → 3-conv
    head (HF DPTNeck + DPTDepthEstimationHead), on token sequences
    [B, 1+N, D] with the cls token first.  Shared by dpt-large, DPT-DINOv2
    and DPT-BEiT (and ZoeDepth's relative head, which reads `return_aux`)."""

    def __init__(self, hidden_size: int, neck_channels: Sequence[int],
                 fusion_channels: int) -> None:
        super().__init__()
        D = hidden_size
        self.readout = nn.ModuleList(nn.Linear(2 * D, D) for _ in neck_channels)
        self.reassemble = nn.ModuleList(
            ReassembleLayer(D, c, f) for c, f in zip(neck_channels, REASSEMBLE_FACTORS))
        self.conv = nn.ModuleList(
            Conv(c, fusion_channels, 3, padding=1, bias=False) for c in neck_channels)
        self.fusion = nn.ModuleList(
            FeatureFusionLayer(fusion_channels, with_residual=j > 0)
            for j in range(len(neck_channels)))
        self.head_conv1 = Conv(fusion_channels, fusion_channels // 2, 3, padding=1)
        self.head_conv2 = Conv(fusion_channels // 2, HEAD_CHANNELS, 3, padding=1)
        self.head_conv3 = Conv(HEAD_CHANNELS, 1, 1)

    def forward(self, feats: Sequence[torch.Tensor], gh: int, gw: int,
                return_aux: bool = False):
        stages = [conv(reassemble(readout_grid(f, readout, gh, gw)))
                  for f, readout, reassemble, conv in zip(feats, self.readout, self.reassemble,
                                                          self.conv)]
        fused_list = fuse(stages, self.fusion)
        depth, feat_mid = classic_head(self, fused_list[-1])
        if return_aux:
            # ZoeDepth's metric head reads the fusion pyramid (coarsest
            # first), the coarsest stage's conv ("bottleneck") and the
            # post-ReLU mid features
            return depth, {"fusion": fused_list, "bottleneck": stages[3],
                           "features": feat_mid}
        return depth


class DPTViT(nn.Module):
    """pixels [B,H,W,3] (normalized) → MiDaS disparity [B,h',w'] at the
    head's resolution.  `quant=True` makes the four products of every ViT
    layer int8 (`QuantLinear`, K4)."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int, mlp_dim: int,
                 out_indices: Tuple[int, ...], neck_channels: Sequence[int],
                 fusion_channels: int, patch_size: int = 16, pretrain_grid: int = 24,
                 quant: bool = False) -> None:
        super().__init__()
        D = hidden_size
        self.patch_size = patch_size
        self.pretrain_grid = pretrain_grid
        self.out_indices = tuple(out_indices)
        self.patch_kernel = nn.Parameter(torch.empty(patch_size * patch_size * 3, D))
        self.patch_bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.position_embeddings = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1, D))
        self.layer = nn.ModuleList(
            ViTLayer(D, num_heads, mlp_dim, quant) for _ in range(num_layers))
        self.decoder = ClassicDPTDecoder(D, neck_channels, fusion_channels)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "DPTViT":
        hidden, layers, heads, mlp, out_idx = DPT_VIT_PRESETS[spec.variant]
        return cls(hidden_size=hidden, num_layers=layers, num_heads=heads, mlp_dim=mlp,
                   out_indices=out_idx, neck_channels=spec.neck_channels,
                   fusion_channels=spec.fusion_channels, patch_size=spec.patch_size,
                   quant=quant)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        gh, gw = pixels.shape[1] // self.patch_size, pixels.shape[2] // self.patch_size
        x = patch_tokens(pixels, self.patch_kernel, self.patch_bias, self.patch_size)
        x = with_cls(x, self.cls_token,
                     position_table(self.position_embeddings, gh, gw, self.pretrain_grid))
        feats = []
        for i, layer in enumerate(self.layer):  # pre-norm hidden states feed the neck
            x = layer(x)
            if i in self.out_indices:
                feats.append(x)
        return self.decoder(feats, gh, gw)


class DPTDinov2(nn.Module):
    """facebook/dpt-dinov2-*: the DINOv2 trunk's last four hidden states,
    final-layernormed with the cls token, into the classic readout decoder.
    ViT-G takes the SwiGLU MLP (`weights_in` / `weights_out`)."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int, mlp_dim: int,
                 neck_channels: Sequence[int], fusion_channels: int, patch_size: int = 14,
                 use_swiglu: bool = False, quant: bool = False) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.backbone = Dinov2Encoder(
            hidden_size, num_layers, num_heads, mlp_dim,
            out_layers=tuple(range(num_layers - 4, num_layers)), patch_size=patch_size,
            quant=quant, use_swiglu=use_swiglu)
        self.decoder = ClassicDPTDecoder(hidden_size, neck_channels, fusion_channels)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "DPTDinov2":
        hidden, layers, heads, mlp = spec.dims
        return cls(hidden_size=hidden, num_layers=layers, num_heads=heads, mlp_dim=mlp,
                   neck_channels=spec.neck_channels, fusion_channels=spec.fusion_channels,
                   patch_size=spec.patch_size, use_swiglu=spec.variant == "vitg",
                   quant=quant)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        gh, gw = pixels.shape[1] // self.patch_size, pixels.shape[2] // self.patch_size
        return self.decoder(list(self.backbone(pixels)), gh, gw)
