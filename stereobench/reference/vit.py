"""DINOv2 ViT trunk in plain float32 PyTorch (arXiv:2304.07193).

Patch-14 embedding (a stride-14 convolution), the cls token and the
position table of a pretrain grid, bicubically interpolated to the input's
grid (align_corners False), pre-norm blocks with LayerScale, softmax
attention written out as two matrix products, the exact-erf GELU MLP, and
the final LayerNorm on the selected hidden states.  Parameter names are the
program's (`embeddings.patch_embeddings.weight` holds each patch's vector
in (row, column, channel) order).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_ATTENTION_LOG: Optional[List[Tuple[int, int, int, int]]] = None


@contextlib.contextmanager
def record_attention() -> Iterator[List[Tuple[int, int, int, int]]]:
    """Collect the [B, N, H, d] shape of every attention call made inside."""
    global _ATTENTION_LOG
    log: List[Tuple[int, int, int, int]] = []
    prev, _ATTENTION_LOG = _ATTENTION_LOG, log
    try:
        yield log
    finally:
        _ATTENTION_LOG = prev


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d) v over [B, N, H, d] → [B, N, H, d]."""
    if _ATTENTION_LOG is not None:
        _ATTENTION_LOG.append(tuple(q.shape))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, d]
    scores = (qh @ kh.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return (scores.softmax(dim=-1) @ vh).transpose(1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, hidden: int, patch: int) -> None:
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(hidden, patch * patch * 3))
        self.bias = nn.Parameter(torch.empty(hidden))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """NCHW pixels → [B, gh·gw, D]."""
        p = self.patch
        w = self.weight.reshape(-1, p, p, 3).permute(0, 3, 1, 2)
        return F.conv2d(pixels, w, self.bias, stride=p).flatten(2).transpose(1, 2)


class Embeddings(nn.Module):
    def __init__(self, hidden: int, patch: int, pretrain_grid: int) -> None:
        super().__init__()
        self.hidden, self.patch, self.grid = hidden, patch, pretrain_grid
        self.patch_embeddings = PatchEmbed(hidden, patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.position_embeddings = nn.Parameter(torch.empty(1, pretrain_grid ** 2 + 1, hidden))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B, _, H, W = pixels.shape
        gh, gw = H // self.patch, W // self.patch
        tokens = self.patch_embeddings(pixels)
        pos = self.position_embeddings
        patch_pos = pos[:, 1:]
        if (gh, gw) != (self.grid, self.grid):
            grid = patch_pos.reshape(1, self.grid, self.grid, self.hidden).permute(0, 3, 1, 2)
            grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
            patch_pos = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, self.hidden)
        cls = self.cls_token.expand(B, 1, self.hidden)
        return torch.cat([cls, tokens], dim=1) + torch.cat([pos[:, :1], patch_pos], dim=1)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        q, k, v = (t.reshape(B, N, self.heads, D // self.heads)
                   for t in self.qkv(x).split(D, dim=-1))
        return self.proj(attention(q, k, v).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp)
        self.fc2 = nn.Linear(mlp, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Layer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int, eps: float) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden, eps=eps)
        self.attention = Attention(hidden, heads)
        self.layer_scale1 = nn.Parameter(torch.empty(hidden))
        self.norm2 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = Mlp(hidden, mlp)
        self.layer_scale2 = nn.Parameter(torch.empty(hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x)) * self.layer_scale1
        return x + self.mlp(self.norm2(x)) * self.layer_scale2


class Dinov2(nn.Module):
    """→ the hidden states of `out_layers` (0-indexed), each LayerNorm'd
    where its index is in `normed` (all of them by default).  Layers after
    the last selected one feed nothing and are not built."""

    def __init__(self, hidden: int, layers: int, heads: int, mlp: int, patch: int,
                 out_layers: Sequence[int], pretrain_grid: int, eps: float,
                 normed: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        self.out_layers = tuple(sorted(out_layers))
        self.normed = set(self.out_layers if normed is None else normed)
        self.embeddings = Embeddings(hidden, patch, pretrain_grid)
        self.layer = nn.ModuleList(Layer(hidden, heads, mlp, eps)
                                   for _ in range(min(layers, max(self.out_layers) + 1)))
        self.layernorm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, pixels: torch.Tensor) -> List[torch.Tensor]:
        x = self.embeddings(pixels)
        out = []
        for i, layer in enumerate(self.layer):
            x = layer(x)
            if i in self.out_layers:
                out.append(self.layernorm(x) if i in self.normed else x)
        return out


def tokens_to_map(tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """[B, 1 + gh·gw, D] (cls first) → NCHW [B, D, gh, gw]."""
    B, _, D = tokens.shape
    return tokens[:, 1:].transpose(1, 2).reshape(B, D, gh, gw)
