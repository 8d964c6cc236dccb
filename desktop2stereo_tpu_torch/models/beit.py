"""BEiT backbone + classic DPT decoder: the MiDaS v3.1 dpt-beit family.

Port of `desktop2stereo_tpu/models/beit.py` (HF DPTForDepthEstimation with a
BeitBackbone, Intel/dpt-beit-base-384 and dpt-beit-large-512).  Against a
plain ViT:

- no absolute position table: every layer adds a relative-position bias
  [H, N+1, N+1] to its attention logits, gathered from a (2W-1)² + 3 table
  (3 entries for cls↔token and cls↔cls), the table interpolated bilinearly
  when the grid differs from the pretraining window W;
- q, k and v are separate products and k has no bias; LayerScale
  `lambda_1` / `lambda_2`;
- the neck takes the raw (pre-norm) hidden states at `out_indices`.

The bias never exists as an [H, N+1, N+1] tensor on the frame path: each
layer hands the attention its interpolated table, transposed to [H, R]
(`multi_head_attention(..., rel_pos=(table, gh, gw))`), and K2's table
entry gathers the bias from it in shared memory.  The tables depend on the
weights and the grid only, so the streaming functions build every layer's
table once per capture shape (`first`, through `compute_rel_pos_tables`:
1.70 MB for BEiT-L at 18×32 in bf16) and carry them from frame to frame
(`step`), where the JAX package's `make_beit_stream_fns` carries the dense
biases; a call without tables (the parity path) builds each layer's own.
`build_rel_pos_bias`, the dense expansion, is the plain oracle.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.models.dinov2 import _dense
from desktop2stereo_tpu_torch.models.dpt_vit import (
    VIT_LN_EPS, ClassicDPTDecoder, patch_tokens, with_cls)
from desktop2stereo_tpu_torch.ops.activations import gelu
from desktop2stereo_tpu_torch.ops.attention import (  # noqa: F401 (the index map, one copy)
    _relative_position_index, expand_rel_pos, multi_head_attention)
from desktop2stereo_tpu_torch.ops.resize import resize

# name → (hidden, layers, heads, mlp, out_indices, pretrain_window)
BEIT_PRESETS = {
    "dpt-beit-base-384": (768, 12, 12, 3072, (2, 5, 8, 11), 24),
    "dpt-beit-large-512": (1024, 24, 16, 4096, (5, 11, 17, 23), 32),
    # ZoeDepth's trunk: BEiT-L/16 pretrained on a 24x24 window
    "zoedepth": (1024, 24, 16, 4096, (5, 11, 17, 23), 24),
}


def interpolate_rel_pos_table(table: torch.Tensor, gh: int, gw: int, pretrain_window: int,
                              num_heads: int) -> torch.Tensor:
    """One layer's table [(2W-1)²+3, H] → the contiguous [H, R] table of a
    gh × gw grid, R = (2gh-1)(2gw-1) + 3, in the table's dtype.  Off the
    pretraining window the (2W-1)² part is resized bilinearly in f32 to
    (2gh-1) × (2gw-1), as HF BeitRelativePositionBias does."""
    M = pretrain_window
    n_rel = (2 * M - 1) ** 2
    if (gh, gw) != (M, M):
        new_h, new_w = 2 * gh - 1, 2 * gw - 1
        sub = table[:n_rel].reshape(2 * M - 1, 2 * M - 1, num_heads).float()
        sub = resize(sub, (new_h, new_w), mode="bilinear")
        table = torch.cat([sub.reshape(new_h * new_w, num_heads),
                           table[n_rel:].float()]).to(table.dtype)
    return table.t().contiguous()


def build_rel_pos_bias(table: torch.Tensor, gh: int, gw: int, pretrain_window: int,
                       num_heads: int) -> torch.Tensor:
    """One layer's table [(2W-1)²+3, H] → contiguous bias [H, N+1, N+1] for a
    gh × gw grid, in the table's dtype: the interpolated table expanded
    through the index map (the plain oracle of the table entry)."""
    return expand_rel_pos(interpolate_rel_pos_table(table, gh, gw, pretrain_window, num_heads),
                          gh, gw)


def compute_rel_pos_tables(backbone: "BeitEncoder", gh: int, gw: int) -> List[torch.Tensor]:
    """Every layer's [H, R] table for one grid: what the streaming `first`
    builds once per capture shape and `step` reuses."""
    return [interpolate_rel_pos_table(layer.relative_position_bias.relative_position_bias_table,
                                      gh, gw, backbone.pretrain_window, backbone.num_heads)
            for layer in backbone.layer]


class BeitRelativePositionBias(nn.Module):
    """One layer's bias table, [(2W-1)² + 3, H]."""

    def __init__(self, num_heads: int, pretrain_window: int) -> None:
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * pretrain_window - 1) ** 2 + 3, num_heads))


class BeitLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int, pretrain_window: int,
                 quant: bool = False) -> None:
        super().__init__()
        D = hidden_size
        self.num_heads = num_heads
        self.pretrain_window = pretrain_window
        self.norm1 = nn.LayerNorm(D, eps=VIT_LN_EPS)
        self.query = _dense(D, D, quant)
        self.key = _dense(D, D, quant, bias=False)
        self.value = _dense(D, D, quant)
        self.relative_position_bias = BeitRelativePositionBias(num_heads, pretrain_window)
        self.proj = _dense(D, D, quant)
        self.lambda_1 = nn.Parameter(torch.ones(D))
        self.norm2 = nn.LayerNorm(D, eps=VIT_LN_EPS)
        self.fc1 = _dense(D, mlp_dim, quant)
        self.fc2 = _dense(mlp_dim, D, quant)
        self.lambda_2 = nn.Parameter(torch.ones(D))

    def forward(self, x: torch.Tensor, gh: int, gw: int,
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, D = x.shape
        if table is None:  # the parity path; the frame program carries the tables
            table = interpolate_rel_pos_table(
                self.relative_position_bias.relative_position_bias_table, gh, gw,
                self.pretrain_window, self.num_heads)
        h = self.norm1(x)
        q, k, v = (f(h).unflatten(-1, (self.num_heads, D // self.num_heads))
                   for f in (self.query, self.key, self.value))
        out = self.proj(multi_head_attention(q, k, v, rel_pos=(table, gh, gw)).reshape(B, N, D))
        x = x + out * self.lambda_1.to(x.dtype)
        h = self.fc2(gelu(self.fc1(self.norm2(x))))
        return x + h * self.lambda_2.to(x.dtype)


class BeitEncoder(nn.Module):
    """Patch tokens and the cls token through the BEiT layers; returns the
    raw token sequences [B, 1+N, D] at `out_indices` and the grid."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int, mlp_dim: int,
                 out_indices: Tuple[int, ...], pretrain_window: int, patch_size: int = 16,
                 quant: bool = False) -> None:
        super().__init__()
        D = hidden_size
        self.num_heads = num_heads
        self.pretrain_window = pretrain_window
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.patch_kernel = nn.Parameter(torch.empty(patch_size * patch_size * 3, D))
        self.patch_bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.layer = nn.ModuleList(
            BeitLayer(D, num_heads, mlp_dim, pretrain_window, quant) for _ in range(num_layers))

    def grid(self, pixels: torch.Tensor) -> Tuple[int, int]:
        return pixels.shape[1] // self.patch_size, pixels.shape[2] // self.patch_size

    def forward(self, pixels: torch.Tensor,
                tables: Optional[Sequence[torch.Tensor]] = None):
        gh, gw = self.grid(pixels)
        x = with_cls(patch_tokens(pixels, self.patch_kernel, self.patch_bias, self.patch_size),
                     self.cls_token)
        feats = []
        for i, layer in enumerate(self.layer):
            x = layer(x, gh, gw, None if tables is None else tables[i])
            if i in self.out_indices:
                feats.append(x)
        return feats, gh, gw


class DPTBEiT(nn.Module):
    """pixels [B,H,W,3] (normalized) → MiDaS disparity [B,h',w'] at the
    head's resolution.  Stateful for the frame program: `first(pixels)` →
    (depth, the layers' [H, R] relative-position tables) and `step(pixels,
    tables)` → (depth, the same tables).  `quant=True` makes query, key, value, proj, fc1 and fc2
    of every layer int8 (K4).  The tables depend on the input's shape alone,
    so a batch of streams carries one set (`carry_per_stream` False)."""

    carry_per_stream = False  # no stream axis in the carry: never masked

    def __init__(self, preset: str, neck_channels: Sequence[int], fusion_channels: int,
                 patch_size: int = 16, quant: bool = False) -> None:
        super().__init__()
        hidden, layers, heads, mlp, out_idx, window = BEIT_PRESETS[preset]
        self.backbone = BeitEncoder(hidden, layers, heads, mlp, out_idx, window,
                                    patch_size=patch_size, quant=quant)
        self.decoder = ClassicDPTDecoder(hidden, neck_channels, fusion_channels)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "DPTBEiT":
        return cls(spec.name, spec.neck_channels, spec.fusion_channels,
                   patch_size=spec.patch_size, quant=quant)

    def forward(self, pixels: torch.Tensor,
                tables: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        feats, gh, gw = self.backbone(pixels, tables)
        return self.decoder(feats, gh, gw)

    def first(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        tables = tuple(compute_rel_pos_tables(self.backbone, *self.backbone.grid(pixels)))
        return self(pixels, tables), tables

    def step(self, pixels: torch.Tensor, tables: Tuple[torch.Tensor, ...]
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        return self(pixels, tables), tables
