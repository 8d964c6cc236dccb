"""DepthPro (apple/DepthPro-hf): a multi-scale patch ViT and a fusion decoder.

Port of `desktop2stereo_tpu/models/depthpro.py` (HF
DepthProForDepthEstimation, square input only, 1536 in the registry):

- the input is resized to three scales (0.25, 0.5, 1) and each is cut into
  overlapping 384-px tiles (1 + 9 + 25); all 35 go through one shared
  DINOv2-L/14 "patch encoder" as one batch, the full-resolution tiles
  first, so K2 runs at batch 35 on 27² + 1 tokens;
- the tiles' last hidden state (final-normed) and the raw hidden states of
  two hook layers on the full-resolution tiles are merged back into image
  maps (overlap trimmed) and resized; a second DINOv2-L, the "image
  encoder", runs on the 384² resize of the input as a global anchor;
- a neck of upsample blocks (a 1x1 projection and k=s=2 ConvTransposes,
  folded into one product + depth-to-space by `compose_expand`, as the JAX
  module folds them), a fusion chain whose ConvT upsample and projection are
  folded the same way, and a 3-conv head with a ConvT: canonical inverse
  depth at twice the last fusion map's side.

The FOV branch is not built: the frame path reads depth only.  Module and
parameter names follow the JAX tree (`from_flax` keeps the upsample blocks'
and the fusion layers' ConvTranspose kernels in their (C, O, 2, 2) layout).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder
from desktop2stereo_tpu_torch.models.dpt import (
    Conv, ConvTransposeSameStride, PreActResidual, apply_expand, compose_expand)
from desktop2stereo_tpu_torch.ops.resize import resize

# apple/DepthPro-hf facts
SCALED_RATIOS = (0.25, 0.5, 1.0)
OVERLAP_RATIOS = (0.0, 0.5, 0.25)
SCALED_DIMS = (1024, 1024, 512)
HOOK_IDS = (11, 5)
HOOK_DIMS = (256, 256)
MERGE_PAD = 3


def split_to_patches(x: torch.Tensor, patch: int, overlap: float) -> torch.Tensor:
    """[B,H,W,C] → [N·B, patch, patch, C] overlapping tiles, row-major over
    the tile positions with the batch inner (HF split_to_patches)."""
    B, H, W, C = x.shape
    if H == W == patch:
        return x
    stride = int(patch * (1 - overlap))
    return torch.cat([x[:, i:i + patch, j:j + patch]
                      for i in range(0, H - patch + 1, stride)
                      for j in range(0, W - patch + 1, stride)], dim=0)


def merge_patches(patches: torch.Tensor, batch: int, padding: int) -> torch.Tensor:
    """[N·B, h, w, C] tiles of a √N × √N grid → [B, H', W', C], each tile's
    inner borders trimmed by `padding` (at most h/4; none under 4 tiles)
    (HF merge_patches)."""
    nb, h, w, _ = patches.shape
    if nb == batch:
        return patches
    n = nb // batch
    side = math.isqrt(n)
    pad = 0 if n < 4 else min(h // 4, padding)
    rows = []
    for r in range(side):
        cols = []
        for c in range(side):
            idx = r * side + c
            box = patches[batch * idx: batch * (idx + 1)]
            top, left = (pad if r else 0), (pad if c else 0)
            bottom, right = (pad if r != side - 1 else 0), (pad if c != side - 1 else 0)
            cols.append(box[:, top: h - bottom, left: w - right])
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


class FeatureUpsampleBlock(nn.Module):
    """An optional 1x1 projection, then `n_upsample` k=s=2 ConvTransposes
    (HF DepthProFeatureUpsampleBlock), run as one composed expansion."""

    def __init__(self, in_channels: int, intermediate: int, out: int, n_upsample: int,
                 use_proj: bool = True, bias: bool = False) -> None:
        super().__init__()
        self.in_channels = in_channels
        layers: List[nn.Module] = []
        cin = in_channels
        if use_proj:
            layers.append(Conv(in_channels, intermediate, 1, bias=bias))
            cin = intermediate
        for _ in range(n_upsample):
            layers.append(ConvTransposeSameStride(cin, out, 2, bias=bias))
            cin = out
        self.use_proj = use_proj
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, *deconvs = self.layers
        if self.use_proj:
            kernel = first.weight[:, :, 0, 0].t().reshape(self.in_channels, 1, 1, -1)
            bias = None if first.bias is None else first.bias.reshape(1, 1, -1)
        else:  # the first ConvTranspose is the start of the chain
            kernel = first.weight.permute(0, 2, 3, 1)         # [C, 2, 2, out]
            bias = None if first.bias is None else first.bias.expand(kernel.shape[1:])
        for d in deconvs:
            kernel, bias = compose_expand(kernel, bias, d.weight, d.bias)
        return apply_expand(x, kernel, bias)


class DepthProFusionLayer(nn.Module):
    """Residual fusion with a learned ConvT upsample (HF
    DepthProFeatureFusionLayer); the ConvT and the 1x1 projection after it
    run as one composed expansion."""

    def __init__(self, channels: int, with_residual: bool, use_deconv: bool = True) -> None:
        super().__init__()
        self.res1 = PreActResidual(channels) if with_residual else None
        self.res2 = PreActResidual(channels)
        self.deconv = ConvTransposeSameStride(channels, channels, 2, bias=False) \
            if use_deconv else None
        self.projection = Conv(channels, channels, 1)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is not None:
            x = x + self.res1(residual)
        x = self.res2(x)
        if self.deconv is None:
            return self.projection(x)
        proj = self.projection.weight[:, :, 0, 0].t()        # [in, out]
        kernel = torch.einsum("cogk,oy->cgky", self.deconv.weight, proj)
        return apply_expand(x, kernel, self.projection.bias)


class DepthPro(nn.Module):
    """pixels [B,S,S,3] (normalized 0.5/0.5; S ≥ 4·patch_px) → inverse
    depth [B, S', S'].  The constructor's fields are the JAX module's, so
    the tests build small instances; `quant=True` makes both ViT towers'
    dense products int8 (K4) and leaves the decoder float."""

    def __init__(self, patch_px: int = 384, vit_hidden: int = 1024, vit_layers: int = 24,
                 vit_heads: int = 16, vit_mlp: int = 4096, vit_patch: int = 14,
                 fusion: int = 256, scaled_dims: Tuple[int, ...] = SCALED_DIMS,
                 hook_ids: Tuple[int, ...] = HOOK_IDS, hook_dims: Tuple[int, ...] = HOOK_DIMS,
                 quant: bool = False) -> None:
        super().__init__()
        self.patch_px, self.vit_hidden = patch_px, vit_hidden
        self.out_size = patch_px // vit_patch                # the ViT grid of one tile
        self.hook_ids = tuple(hook_ids)
        self.last = vit_layers - 1
        self.tapped = sorted({*hook_ids, self.last})

        def encoder(out_layers, final_norm=None):
            return Dinov2Encoder(vit_hidden, vit_layers, vit_heads, vit_mlp, tuple(out_layers),
                                 patch_size=vit_patch, quant=quant, pretrain_grid=self.out_size,
                                 final_norm_indices=final_norm)

        self.patch_encoder = encoder(self.tapped, (self.last,))
        self.image_encoder = encoder((self.last,))
        self.image_block = FeatureUpsampleBlock(vit_hidden, vit_hidden, scaled_dims[0], 1,
                                                use_proj=False, bias=True)
        self.scaled = nn.ModuleList(FeatureUpsampleBlock(vit_hidden, d, d, 1)
                                    for d in scaled_dims)
        self.intermediate = nn.ModuleList(
            FeatureUpsampleBlock(vit_hidden, fusion if i == 0 else d, d, 2 + i)
            for i, d in enumerate(hook_dims))
        self.fuse_image_low_res = Conv(2 * scaled_dims[0], scaled_dims[0], 1)
        combined = (*scaled_dims, *hook_dims)
        n_proj = len(combined) - (combined[-1] == fusion)    # the last one may pass as is
        self.projection = nn.ModuleList(Conv(c, fusion, 3, padding=1, bias=False)
                                        for c in combined[:n_proj])
        self.fusion = nn.ModuleList(DepthProFusionLayer(fusion, with_residual=j > 0)
                                    for j in range(len(combined) - 1))
        self.fusion_final = DepthProFusionLayer(fusion, with_residual=True, use_deconv=False)
        self.head_conv1 = Conv(fusion, fusion // 2, 3, padding=1)
        self.head_deconv = ConvTransposeSameStride(fusion // 2, fusion // 2, 2)
        self.head_conv2 = Conv(fusion // 2, 32, 3, padding=1)
        self.head_conv3 = Conv(32, 1, 1)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "DepthPro":
        return cls(quant=quant)

    def _grid(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens[:, 1:].reshape(tokens.shape[0], self.out_size, self.out_size, -1)

    def encode(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """→ (the image encoder's map [B, base, base, D], the five encoder
        maps: three scales, coarsest first, then the hooks)."""
        B, H, W, _ = pixels.shape
        if H != W or H * SCALED_RATIOS[0] < self.patch_px:
            raise ValueError(f"DepthPro needs a square input of at least "
                             f"{int(self.patch_px / SCALED_RATIOS[0])} px a side (its coarsest "
                             f"scale must hold one {self.patch_px}-px tile), got {H}x{W}")
        scaled = [pixels if r == 1.0 else resize(pixels, (int(H * r), int(W * r)),
                                                 mode="bilinear") for r in SCALED_RATIOS]
        tiles = [split_to_patches(s, self.patch_px, o) for s, o in zip(scaled, OVERLAP_RATIOS)]
        n_tiles = [t.shape[0] for t in tiles]
        by_layer = dict(zip(self.tapped, self.patch_encoder(torch.cat(tiles[::-1], dim=0))))
        # the last hidden state back per scale, the full-resolution tiles first
        per_scale = self._grid(by_layer[self.last]).split(n_tiles[::-1], dim=0)[::-1]
        base = H // 2 ** int(math.log2(W / self.out_size))
        features = [resize(merge_patches(t, B, int(MERGE_PAD / r)), (base * 2 ** i,) * 2,
                           mode="bilinear")
                    for i, (t, r) in enumerate(zip(per_scale, SCALED_RATIOS))]
        side = base * 2 ** (len(SCALED_RATIOS) - 1)
        for hid in self.hook_ids:
            merged = merge_patches(self._grid(by_layer[hid])[:n_tiles[-1]], B, MERGE_PAD)
            features.append(resize(merged, (side, side), mode="bilinear"))
        small = resize(pixels, (self.patch_px, self.patch_px), mode="bilinear")
        image = resize(self._grid(self.image_encoder(small)[0]), (base, base), mode="bilinear")
        return image, features

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        image, features = self.encode(pixels)
        n_scaled = len(self.scaled)
        ups = [self.image_block(image)]
        ups += [block(f) for block, f in zip(self.scaled, features)]
        ups += [block(f) for block, f in zip(self.intermediate, features[n_scaled:])]
        necked = [self.fuse_image_low_res(torch.cat([ups[1], ups[0]], dim=-1)), *ups[2:]]
        hidden = [proj(f) for proj, f in zip(self.projection, necked)]
        hidden += necked[len(hidden):]
        fused = None
        for layer, h in zip(self.fusion, hidden[:-1]):
            fused = layer(h) if fused is None else layer(fused, h)
        fused = self.fusion_final(fused, hidden[-1])
        x = self.head_deconv(self.head_conv1(fused))
        x = self.head_conv3(torch.relu(self.head_conv2(x)))
        return torch.relu(x)[..., 0]
