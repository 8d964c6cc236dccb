"""DPT neck + depth head, the Depth-Anything decoder (NHWC).

Port of `desktop2stereo_tpu/models/dpt.py`: reassemble (1x1 projection, then
k=s conv-transpose ×4 / ×2, identity, or a stride-2 conv), 3x3 neck convs,
the coarsest-first feature-fusion pyramid of pre-activation residual units
with align_corners bilinear upsampling, and the 3-conv head.

Convolutions run through `F.conv2d` on an NCHW view of the NHWC activations
(a channels-last layout, which cuDNN takes directly).  The JAX package's
`LanePaddedConv` / `_PaddedInputConv` are TPU lane-padding devices that are
bit-exact to plain convs, so they are plain convs here.  The k=s
conv-transpose stays a matmul + depth-to-space, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.ops.resize import resize

# Reassemble rescale per neck stage: ×4 and ×2 conv-transposes, identity,
# and a stride-2 conv (-2); models/from_flax.py reads this too.
REASSEMBLE_FACTORS = (4, 2, 1, -2)
HEAD_CHANNELS = 32  # the head's last hidden width (HF head_hidden_size)


class Conv(nn.Conv2d):
    """nn.Conv2d on NHWC tensors (flax nn.Conv's layout)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def apply_expand(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """k=s=f ConvTranspose as one matmul + depth-to-space.
    kernel [C, f, f, O]; out[b, f·i+p, f·j+q, o] = Σ_c x[b,i,j,c]·kernel[c,p,q,o] + bias[o]."""
    B, H, W, C = x.shape
    _, f, f2, O = kernel.shape
    y = x.reshape(-1, C) @ kernel.to(x.dtype).reshape(C, f * f2 * O)
    if bias is not None:  # [O], or [f, f, O] (a composed expansion's)
        y = y + bias.to(x.dtype).expand(f, f2, O).reshape(-1)
    y = y.reshape(B, H, W, f, f2, O).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, H * f, W * f2, O)


def compose_expand(kernel: torch.Tensor, bias: Optional[torch.Tensor],
                   deconv_kernel: torch.Tensor, deconv_bias: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A k=s=2 ConvTranspose folded after an expansion: kernel [C,P,P,O] ∘
    deconv (O, O2, 2, 2) → [C, 2P, 2P, O2], the biases composed affinely
    ([2P, 2P, O2], or None).  Both are linear maps, so a chain of them is
    one product + depth-to-space (`apply_expand`)."""
    C, P, _, O = kernel.shape
    O2 = deconv_kernel.shape[1]
    k2 = torch.einsum("cpqo,oygk->cpgqky", kernel, deconv_kernel).reshape(C, 2 * P, 2 * P, O2)
    b2 = None
    if bias is not None:
        b2 = torch.einsum("pqo,oygk->pgqky", bias, deconv_kernel).reshape(2 * P, 2 * P, O2)
    if deconv_bias is not None:
        b2 = (deconv_bias if b2 is None else b2 + deconv_bias).expand(2 * P, 2 * P, O2)
    return k2, b2


class ConvTransposeSameStride(nn.Module):
    """ConvTranspose2d(C, O, k=f, s=f); weight in torch's (C, O, f, f) layout."""

    def __init__(self, in_channels: int, channels: int, factor: int, bias: bool = True) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, channels, factor, factor))
        self.bias = nn.Parameter(torch.zeros(channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_expand(x, self.weight.permute(0, 2, 3, 1), self.bias)


class ReassembleLayer(nn.Module):
    def __init__(self, in_channels: int, channels: int, factor: int) -> None:
        super().__init__()
        self.projection = Conv(in_channels, channels, 1)
        if factor > 1:
            self.resize = ConvTransposeSameStride(channels, channels, factor)
        elif factor < 0:
            self.resize = Conv(channels, channels, 3, stride=-factor, padding=1)
        else:
            self.resize = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(x))


class PreActResidual(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, padding=1)
        self.conv2 = Conv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionLayer(nn.Module):
    def __init__(self, channels: int, with_residual: bool) -> None:
        super().__init__()
        # the first (coarsest) stage has no lateral input and no res1
        self.res1 = PreActResidual(channels) if with_residual else None
        self.res2 = PreActResidual(channels)
        self.projection = Conv(channels, channels, 1)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if residual is not None:
            if residual.shape != x.shape:
                residual = resize(residual, (x.shape[1], x.shape[2]), mode="bilinear")
            x = x + self.res1(residual)
        x = self.res2(x)
        target = size if size is not None else (x.shape[1] * 2, x.shape[2] * 2)
        x = resize(x, target, mode="bilinear", align_corners=True)
        return self.projection(x)


class DPTNeck(nn.Module):
    def __init__(self, hidden_size: int, neck_channels: Sequence[int],
                 fusion_channels: int) -> None:
        super().__init__()
        self.reassemble = nn.ModuleList(
            ReassembleLayer(hidden_size, c, f)
            for c, f in zip(neck_channels, REASSEMBLE_FACTORS))
        self.conv = nn.ModuleList(
            Conv(c, fusion_channels, 3, padding=1, bias=False) for c in neck_channels)
        self.fusion = nn.ModuleList(
            FeatureFusionLayer(fusion_channels, with_residual=i > 0)
            for i in range(len(neck_channels)))

    def forward(self, grids: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = [conv(re(g)) for g, re, conv in zip(grids, self.reassemble, self.conv)]
        rev = feats[::-1]  # fusion runs coarsest-first
        fused = None
        for idx, (f, layer) in enumerate(zip(rev, self.fusion)):
            size = (rev[idx + 1].shape[1], rev[idx + 1].shape[2]) if idx + 1 < len(rev) else None
            fused = layer(f, None, size) if fused is None else layer(fused, f, size)
        return fused


class DPTHead(nn.Module):
    def __init__(self, fusion_channels: int, patch_size: int = 14,
                 metric: bool = False, max_depth: float = 1.0) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.metric = metric
        self.max_depth = max_depth
        self.conv1 = Conv(fusion_channels, fusion_channels // 2, 3, padding=1)
        self.conv2 = Conv(fusion_channels // 2, HEAD_CHANNELS, 3, padding=1)
        self.conv3 = Conv(HEAD_CHANNELS, 1, 1)

    def forward(self, fused: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
        gh, gw = grid_hw
        x = self.conv1(fused)
        x = resize(x, (gh * self.patch_size, gw * self.patch_size),
                   mode="bilinear", align_corners=True)
        x = self.conv3(F.relu(self.conv2(x)))
        x = torch.sigmoid(x) * self.max_depth if self.metric else F.relu(x)
        return x[..., 0]  # [B, H, W]
