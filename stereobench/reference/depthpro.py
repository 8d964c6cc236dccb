"""DepthPro (arXiv:2410.02073, HF DepthProForDepthEstimation) in plain
float32 PyTorch, square input, depth only.

The input at three scales (0.25, 0.5, 1) is cut into overlapping tiles of
`patch_size` pixels (1 + 9 + 25 at 1536); all of them go through one shared
DINOv2 "patch encoder" as one batch, the full-resolution tiles first.  The
tiles' last hidden state (final-normed) and the raw hidden states of two
hook layers on the full-resolution tiles are merged back into maps (the
overlap trimmed) and resized bilinearly; a second DINOv2, the "image
encoder", reads the input resized to one tile.  The decoder: upsample
blocks (a 1x1 projection and k=s=2 transposed convolutions), a fusion
chain of pre-activation residual units with a transposed-convolution
upsample and a 1x1 projection, and a head (3x3 convolution, a k=s=2
transposed convolution, 3x3, ReLU, 1x1, ReLU): depth at twice the last
fusion map's side.  The FOV branch is not built: the frame path reads depth
only.  NCHW throughout; parameter names are the program's.  Inside
`tables.folded()` the resizes and the upsample and fusion expansions run
as one composed kernel each (`tables.py`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereobench.reference import tables, vit
from stereobench.reference.depth_anything import PreActResidual


def split_to_patches(x: torch.Tensor, patch: int, overlap: float) -> torch.Tensor:
    """NCHW → overlapping tiles [N·B, C, patch, patch], row-major over the
    tile positions with the batch inner."""
    H, W = x.shape[-2:]
    if H == W == patch:
        return x
    stride = int(patch * (1 - overlap))
    return torch.cat([x[..., i:i + patch, j:j + patch]
                      for i in range(0, H - patch + 1, stride)
                      for j in range(0, W - patch + 1, stride)], dim=0)


def merge_patches(tiles: torch.Tensor, batch: int, padding: int) -> torch.Tensor:
    """Tiles [N·B, C, h, w] of a √N × √N grid → [B, C, H', W'], each tile's
    inner borders trimmed by `padding` (at most h/4; none under 4 tiles)."""
    nb, _, h, w = tiles.shape
    if nb == batch:
        return tiles
    n = nb // batch
    side = math.isqrt(n)
    pad = 0 if n < 4 else min(h // 4, padding)
    rows = []
    for r in range(side):
        cols = []
        for c in range(side):
            box = tiles[batch * (r * side + c): batch * (r * side + c + 1)]
            top, left = (pad if r else 0), (pad if c else 0)
            bottom, right = (pad if r != side - 1 else 0), (pad if c != side - 1 else 0)
            cols.append(box[..., top: h - bottom, left: w - right])
        rows.append(torch.cat(cols, dim=-1))
    return torch.cat(rows, dim=-2)


def _bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return tables.interpolate(x, size, align_corners=False)


class UpsampleBlock(nn.Module):
    def __init__(self, cin: int, inter: int, out: int, n_up: int, use_proj: bool = True,
                 bias: bool = False) -> None:
        super().__init__()
        layers: List[nn.Module] = []
        c = cin
        if use_proj:
            layers.append(nn.Conv2d(cin, inter, 1, bias=bias))
            c = inter
        for _ in range(n_up):
            layers.append(nn.ConvTranspose2d(c, out, 2, stride=2, bias=bias))
            c = out
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tables.folded_active() and len(self.layers) > 1:
            first, *rest = self.layers
            if isinstance(first, nn.Conv2d):
                kernel = first.weight[:, :, 0, 0].t()[:, :, None, None]
                bias = None if first.bias is None else first.bias.view(-1, 1, 1)
            else:
                kernel = first.weight
                bias = None if first.bias is None else first.bias.view(-1, 1, 1).expand(-1, 2, 2)
            for d in rest:
                kernel, bias = tables.compose(kernel, bias, d.weight, d.bias)
            return tables.expand(x, kernel, bias)
        for layer in self.layers:
            x = layer(x)
        return x


class FusionLayer(nn.Module):
    def __init__(self, c: int, with_residual: bool, use_deconv: bool = True) -> None:
        super().__init__()
        self.res1 = PreActResidual(c) if with_residual else None
        self.res2 = PreActResidual(c)
        self.deconv = nn.ConvTranspose2d(c, c, 2, stride=2, bias=False) if use_deconv else None
        self.projection = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor, lateral: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lateral is not None:
            x = x + self.res1(lateral)
        x = self.res2(x)
        if self.deconv is not None and tables.folded_active():
            kernel = torch.einsum("cogk,yo->cygk", self.deconv.weight,
                                  self.projection.weight[:, :, 0, 0])
            return tables.expand(x, kernel, self.projection.bias)
        if self.deconv is not None:
            x = self.deconv(x)
        return self.projection(x)


class DepthPro(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        self.tile = cfg["patch_size"]
        self.ratios = tuple(cfg["scaled_images_ratios"])
        self.overlaps = tuple(cfg["scaled_images_overlap_ratios"])
        self.merge_pad = cfg["merge_padding_value"]
        self.hook_ids = tuple(cfg["intermediate_hook_ids"])
        hidden, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
        vit_patch = cfg["vit_patch_size"]
        self.grid = self.tile // vit_patch
        self.last = layers - 1
        self.tapped = sorted({*self.hook_ids, self.last})
        fusion = cfg["fusion_hidden_size"]
        scaled_dims = tuple(cfg["scaled_images_feature_dims"])
        hook_dims = tuple(cfg["intermediate_feature_dims"])

        def encoder(out_layers, normed=None):
            return vit.Dinov2(hidden, layers, cfg["num_attention_heads"],
                              cfg["intermediate_size"], vit_patch, out_layers, self.grid,
                              cfg["layer_norm_eps"], normed)

        self.patch_encoder = encoder(self.tapped, (self.last,))
        self.image_encoder = encoder((self.last,))
        self.image_block = UpsampleBlock(hidden, hidden, scaled_dims[0], 1, use_proj=False,
                                         bias=True)
        self.scaled = nn.ModuleList(UpsampleBlock(hidden, d, d, 1) for d in scaled_dims)
        self.intermediate = nn.ModuleList(
            UpsampleBlock(hidden, fusion if i == 0 else d, d, 2 + i)
            for i, d in enumerate(hook_dims))
        self.fuse_image_low_res = nn.Conv2d(2 * scaled_dims[0], scaled_dims[0], 1)
        combined = (*scaled_dims, *hook_dims)
        n_proj = len(combined) - (combined[-1] == fusion)
        self.projection = nn.ModuleList(nn.Conv2d(c, fusion, 3, padding=1, bias=False)
                                        for c in combined[:n_proj])
        self.fusion = nn.ModuleList(FusionLayer(fusion, j > 0) for j in range(len(combined) - 1))
        self.fusion_final = FusionLayer(fusion, True, use_deconv=False)
        self.head_conv1 = nn.Conv2d(fusion, fusion // 2, 3, padding=1)
        self.head_deconv = nn.ConvTranspose2d(fusion // 2, fusion // 2, 2, stride=2)
        self.head_conv2 = nn.Conv2d(fusion // 2, cfg["head_hidden_size"], 3, padding=1)
        self.head_conv3 = nn.Conv2d(cfg["head_hidden_size"], 1, 1)

    def _map(self, tokens: torch.Tensor) -> torch.Tensor:
        return vit.tokens_to_map(tokens, self.grid, self.grid)

    def encode(self, pixels: torch.Tensor):
        B, _, H, W = pixels.shape
        scaled = [pixels if r == 1.0 else _bilinear(pixels, (int(H * r), int(W * r)))
                  for r in self.ratios]
        tiles = [split_to_patches(s, self.tile, o) for s, o in zip(scaled, self.overlaps)]
        n_tiles = [t.shape[0] for t in tiles]
        by_layer = dict(zip(self.tapped, self.patch_encoder(torch.cat(tiles[::-1], dim=0))))
        per_scale = self._map(by_layer[self.last]).split(n_tiles[::-1], dim=0)[::-1]
        base = H // 2 ** int(math.log2(W / self.grid))
        feats = [_bilinear(merge_patches(t, B, int(self.merge_pad / r)), (base * 2 ** i,) * 2)
                 for i, (t, r) in enumerate(zip(per_scale, self.ratios))]
        side = base * 2 ** (len(self.ratios) - 1)
        for hid in self.hook_ids:
            merged = merge_patches(self._map(by_layer[hid])[:n_tiles[-1]], B, self.merge_pad)
            feats.append(_bilinear(merged, (side, side)))
        small = _bilinear(pixels, (self.tile, self.tile))
        image = _bilinear(self._map(self.image_encoder(small)[0]), (base, base))
        return image, feats

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        image, feats = self.encode(pixels)
        n = len(self.scaled)
        ups = [self.image_block(image)]
        ups += [block(f) for block, f in zip(self.scaled, feats)]
        ups += [block(f) for block, f in zip(self.intermediate, feats[n:])]
        necked = [self.fuse_image_low_res(torch.cat([ups[1], ups[0]], dim=1)), *ups[2:]]
        hidden = [proj(f) for proj, f in zip(self.projection, necked)]
        hidden += necked[len(hidden):]
        fused = None
        for layer, h in zip(self.fusion, hidden[:-1]):
            fused = layer(h) if fused is None else layer(fused, h)
        fused = self.fusion_final(fused, hidden[-1])
        x = self.head_deconv(self.head_conv1(fused))
        return F.relu(self.head_conv3(F.relu(self.head_conv2(x))))[:, 0]


def build(cfg: dict) -> nn.Module:
    return DepthPro(cfg)


def model_input_size(cfg: dict, oh: int, ow: int) -> Tuple[int, int]:
    """Square only: depth_resolution² whatever the frame's aspect."""
    return cfg["depth_resolution"], cfg["depth_resolution"]


RESIZE_MODE = ("bilinear", False)  # the capture → model input resize: mode, antialias
