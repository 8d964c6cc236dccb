"""DINOv2 ViT encoder, the backbone of the Depth-Anything family.

Port of `desktop2stereo_tpu/models/dinov2.py`: patch-14 embedding as reshape +
one matmul, cls token + bicubically interpolated position embeddings,
pre-norm blocks with LayerScale, exact-GELU MLP (tanh form in bf16) or
ViT-G's SwiGLU (`weights_in` / `weights_out`, HF Dinov2SwiGLUFFN), fused
qkv, and the final LayerNorm on each selected hidden state.  NHWC pixels in,
[B, N, D] tokens throughout.  Attention goes through `multi_head_attention`,
which runs the CUDA kernel on every layer when the tensors are on the GPU;
with `quant=True` the qkv, proj and MLP products are int8 (K4).

Module and parameter names follow the JAX parameter tree so `from_flax`
maps it mechanically (see models/from_flax.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.ops.activations import gelu
from desktop2stereo_tpu_torch.ops.attention import multi_head_attention
from desktop2stereo_tpu_torch.ops.quant import QuantLinear
from desktop2stereo_tpu_torch.ops.resize import resize

LN_EPS = 1e-6
PRETRAIN_GRID = 37  # 518 / 14: the position table holds 37² + 1 entries


def patch_vectors(pixels: torch.Tensor, p: int) -> torch.Tensor:
    """[B,H,W,C] → [B, gh·gw, p·p·C], each p×p patch as one vector in
    (p_h, p_w, C) order; a stride-p conv drops the remainder rows and
    columns, and so does this."""
    B, H, W, C = pixels.shape
    gh, gw = H // p, W // p
    x = pixels[:, : gh * p, : gw * p].reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, p * p * C)


class PatchEmbed(nn.Module):
    """Conv2d(3, D, k=p, s=p) as patch vectors (order p_h, p_w, C) @ weightᵀ."""

    def __init__(self, hidden_size: int, patch_size: int = 14) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.empty(hidden_size, patch_size * patch_size * 3))
        self.bias = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return F.linear(patch_vectors(pixels, self.patch_size), self.weight, self.bias)


class Dinov2Embeddings(nn.Module):
    """Patch tokens, the cls token and the position table of a
    `pretrain_grid`² grid (37 for 518-pixel DINOv2, 27 for DepthPro's 384-px
    tiles), bicubically interpolated to another grid.  `interpolate_offset`
    (0.1 for the original DINOv2 weights VDA ships) samples the table at
    scale (g + offset) / M, as the original code's scale_factor call does;
    HF's DINOv2 uses 0."""

    def __init__(self, hidden_size: int, patch_size: int = 14,
                 interpolate_offset: float = 0.0, pretrain_grid: int = PRETRAIN_GRID) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.patch_size = patch_size
        self.interpolate_offset = interpolate_offset
        self.pretrain_grid = pretrain_grid
        self.patch_embeddings = PatchEmbed(hidden_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, pretrain_grid * pretrain_grid + 1, hidden_size))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = pixels.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        tokens = self.patch_embeddings(pixels)
        pos = self.position_embeddings
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        M = self.pretrain_grid
        if (gh, gw) != (M, M):
            # HF interpolates in f32, bicubic, align_corners=False
            grid = patch_pos.reshape(M, M, self.hidden_size).float()
            off = self.interpolate_offset
            scale = ((gh + off) / M, (gw + off) / M) if off else None
            grid = resize(grid, (gh, gw), mode="bicubic", scale_override=scale)
            patch_pos = grid.reshape(1, gh * gw, self.hidden_size).to(pos.dtype)
        pos_full = torch.cat([cls_pos, patch_pos], dim=1)
        cls = self.cls_token.expand(B, 1, self.hidden_size).to(tokens.dtype)
        return torch.cat([cls, tokens], dim=1) + pos_full.to(tokens.dtype)


def _dense(in_features: int, out_features: int, quant: bool, bias: bool = True) -> nn.Module:
    """nn.Linear, or the int8 QuantLinear when the encoder runs quantized."""
    if quant:
        return QuantLinear(in_features, out_features, bias=bias)
    return nn.Linear(in_features, out_features, bias=bias)


class Mlp(nn.Module):
    def __init__(self, hidden_size: int, mlp_dim: int, quant: bool = False) -> None:
        super().__init__()
        self.fc1 = _dense(hidden_size, mlp_dim, quant)
        self.fc2 = _dense(mlp_dim, hidden_size, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


def swiglu_hidden(mlp_dim: int) -> int:
    """ViT-G's SwiGLU hidden width: int(mlp · 2/3) rounded up to a multiple of 8."""
    return (int(mlp_dim * 2 / 3) + 7) // 8 * 8


def swiglu(x: torch.Tensor, w_in: nn.Module, w_out: nn.Module) -> torch.Tensor:
    """w_in to twice the hidden width → silu(x1) · x2 → w_out."""
    x1, x2 = w_in(x).chunk(2, dim=-1)
    return w_out(F.silu(x1) * x2)


class SwiGLU(nn.Module):
    """dinov2-giant FFN in HF's naming (`weights_in` / `weights_out`)."""

    def __init__(self, hidden_size: int, mlp_dim: int, quant: bool = False) -> None:
        super().__init__()
        hidden = swiglu_hidden(mlp_dim)
        self.weights_in = _dense(hidden_size, 2 * hidden, quant)
        self.weights_out = _dense(hidden, hidden_size, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.weights_in, self.weights_out)


class Attention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, quant: bool = False) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = _dense(hidden_size, 3 * hidden_size, quant)
        self.proj = _dense(hidden_size, hidden_size, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        hd = D // self.num_heads
        # strided views of the fused projection; the kernel reads them as is
        q, k, v = (t.unflatten(-1, (self.num_heads, hd))
                   for t in self.qkv(x).split(D, dim=-1))
        out = multi_head_attention(q, k, v).reshape(B, N, D)
        return self.proj(out)


class Dinov2Layer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 quant: bool = False, use_swiglu: bool = False) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.attention = Attention(hidden_size, num_heads, quant)
        self.layer_scale1 = nn.Parameter(torch.ones(hidden_size))
        self.norm2 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.mlp = (SwiGLU if use_swiglu else Mlp)(hidden_size, mlp_dim, quant)
        self.layer_scale2 = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x)) * self.layer_scale1.to(x.dtype)
        return x + self.mlp(self.norm2(x)) * self.layer_scale2.to(x.dtype)


class Dinov2Encoder(nn.Module):
    """ViT trunk returning the hidden states of `out_layers` (0-indexed, in
    layer order), LayerNorm'd; with `final_norm_indices`, only those layers'
    states are (DepthPro's hooks read the raw states, HF Dinov2Model's
    semantics).  Layers after the last selected one feed nothing and are
    not built, as in the JAX module.  `quant` makes the four dense products
    of every layer int8 (`QuantLinear`, kernel K4); `use_swiglu` is ViT-G's
    MLP."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int,
                 mlp_dim: int, out_layers: Tuple[int, ...], patch_size: int = 14,
                 quant: bool = False, interpolate_offset: float = 0.0,
                 use_swiglu: bool = False, pretrain_grid: int = PRETRAIN_GRID,
                 final_norm_indices: Optional[Tuple[int, ...]] = None) -> None:
        super().__init__()
        self.out_layers = tuple(sorted(out_layers))
        self.normed = set(self.out_layers if final_norm_indices is None else final_norm_indices)
        self.embeddings = Dinov2Embeddings(hidden_size, patch_size, interpolate_offset,
                                           pretrain_grid)
        n_run = min(num_layers, max(self.out_layers) + 1)
        self.layer = nn.ModuleList(
            Dinov2Layer(hidden_size, num_heads, mlp_dim, quant, use_swiglu)
            for _ in range(n_run))
        self.layernorm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.embeddings(pixels)
        outputs = []
        for i, layer in enumerate(self.layer):
            x = layer(x)
            if i in self.out_layers:
                outputs.append(self.layernorm(x) if i in self.normed else x)
        return tuple(outputs)
