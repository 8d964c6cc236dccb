"""Depth-Anything-V2 (arXiv:2406.09414) in plain float32 PyTorch: a DINOv2
trunk, then the DPT neck and head (HF DepthAnythingForDepthEstimation).

Neck: per selected hidden state a 1x1 projection and a resize (a k=s=4 or
k=s=2 transposed convolution, identity, or a stride-2 3x3 convolution), a
3x3 convolution to the fusion width, and the coarsest-first fusion
pyramid of pre-activation residual units, each stage upsampled bilinearly
(align_corners True) to the next one's size (the last one ×2).  Head: a
3x3 convolution, a bilinear (align_corners True) resize to the input's
size, a 3x3 convolution, ReLU, a 1x1 convolution and ReLU (relative depth).
NCHW throughout; parameter names are the program's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereobench.reference import tables, vit

RESIZE_FACTORS = (4, 2, 1, -2)


class Reassemble(nn.Module):
    def __init__(self, hidden: int, channels: int, factor: int) -> None:
        super().__init__()
        self.projection = nn.Conv2d(hidden, channels, 1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(channels, channels, factor, stride=factor)
        elif factor < 0:
            self.resize = nn.Conv2d(channels, channels, 3, stride=-factor, padding=1)
        else:
            self.resize = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(x))


class PreActResidual(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class Fusion(nn.Module):
    def __init__(self, c: int, with_residual: bool) -> None:
        super().__init__()
        self.res1 = PreActResidual(c) if with_residual else None
        self.res2 = PreActResidual(c)
        self.projection = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor, lateral: Optional[torch.Tensor],
                size: Optional[Tuple[int, int]]) -> torch.Tensor:
        if lateral is not None:
            if lateral.shape != x.shape:
                lateral = tables.interpolate(lateral, x.shape[-2:], align_corners=False)
            x = x + self.res1(lateral)
        x = self.res2(x)
        size = size or (2 * x.shape[-2], 2 * x.shape[-1])
        return self.projection(tables.interpolate(x, size, align_corners=True))


class Neck(nn.Module):
    def __init__(self, hidden: int, channels: Sequence[int], fusion: int) -> None:
        super().__init__()
        self.reassemble = nn.ModuleList(Reassemble(hidden, c, f)
                                        for c, f in zip(channels, RESIZE_FACTORS))
        self.conv = nn.ModuleList(nn.Conv2d(c, fusion, 3, padding=1, bias=False)
                                  for c in channels)
        self.fusion = nn.ModuleList(Fusion(fusion, i > 0) for i in range(len(channels)))

    def forward(self, maps):
        feats = [conv(re(m)) for m, re, conv in zip(maps, self.reassemble, self.conv)][::-1]
        fused = None
        for i, (f, layer) in enumerate(zip(feats, self.fusion)):
            size = tuple(feats[i + 1].shape[-2:]) if i + 1 < len(feats) else None
            fused = layer(f, None, size) if fused is None else layer(fused, f, size)
        return fused


class Head(nn.Module):
    def __init__(self, fusion: int, hidden: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(fusion, fusion // 2, 3, padding=1)
        self.conv2 = nn.Conv2d(fusion // 2, hidden, 3, padding=1)
        self.conv3 = nn.Conv2d(hidden, 1, 1)

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        x = tables.interpolate(self.conv1(x), size, align_corners=True)
        return F.relu(self.conv3(F.relu(self.conv2(x))))[:, 0]


class DepthAnythingV2(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        self.patch = cfg["patch_size"]
        self.backbone = vit.Dinov2(cfg["hidden_size"], cfg["num_hidden_layers"],
                                   cfg["num_attention_heads"], cfg["intermediate_size"],
                                   self.patch, cfg["out_indices"], cfg["pretrain_grid"],
                                   cfg["layer_norm_eps"])
        self.neck = Neck(cfg["hidden_size"], cfg["neck_hidden_sizes"], cfg["fusion_hidden_size"])
        self.head = Head(cfg["fusion_hidden_size"], cfg["head_hidden_size"])

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        gh, gw = pixels.shape[-2] // self.patch, pixels.shape[-1] // self.patch
        maps = [vit.tokens_to_map(t, gh, gw) for t in self.backbone(pixels)]
        return self.head(self.neck(maps), (gh * self.patch, gw * self.patch))


def build(cfg: dict) -> nn.Module:
    return DepthAnythingV2(cfg)


def patch_aligned_size(h: int, w: int, target: int, patch: int) -> Tuple[int, int]:
    """Longest side → target, each side snapped to the nearest patch multiple."""
    longest = max(h, w)
    scale = target / float(longest) if longest != target else 1.0
    sh, sw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))

    def nearest(v: int) -> int:
        down = (v // patch) * patch
        return down + patch if abs(down + patch - v) <= abs(v - down) else down

    return max(patch, nearest(sh)), max(patch, nearest(sw))


def model_input_size(cfg: dict, oh: int, ow: int) -> Tuple[int, int]:
    return patch_aligned_size(oh, ow, cfg["depth_resolution"], cfg["patch_size"])


RESIZE_MODE = ("bicubic", True)  # the capture → model input resize: mode, antialias
