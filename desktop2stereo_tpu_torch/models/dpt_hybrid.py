"""DPT-Hybrid (MiDaS 3.0 dpt-hybrid-midas): a BiT/ResNetv2 stem under a
ViT trunk.

Port of `desktop2stereo_tpu/models/dpt_hybrid.py`: a 3-stage BiT convnet
(weight-standardized convs, GroupNorm + ReLU bottlenecks, TF-SAME padding)
whose stride-16 map becomes the ViT's tokens through a 1x1 projection; the
first two conv stages feed the DPT neck directly, and ViT layers 8 and 11
feed the two coarse stages through the readout projection (identity, then a
stride-2 conv).  NHWC throughout; module names follow the JAX tree.

TF-SAME: a stride-s, size-k window over n pixels gives ⌈n/s⌉ outputs and
pads max((⌈n/s⌉-1)·s + k - n, 0) pixels, the smaller half before.  PyTorch's
`padding="same"` takes no stride, so the convs and the stem's max pool pad
explicitly.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.models.dpt import Conv, FeatureFusionLayer, ReassembleLayer
from desktop2stereo_tpu_torch.models.dpt_vit import (
    ViTLayer, classic_head, fuse, position_table, readout_grid, with_cls)

# dpt-hybrid-midas facts (HF Intel/dpt-hybrid-midas config)
BIT_DEPTHS = (3, 4, 9)
BIT_HIDDEN = (256, 512, 1024)
BIT_EMBED = 64
VIT_HIDDEN, VIT_LAYERS, VIT_HEADS, VIT_MLP = 768, 12, 12, 3072
VIT_OUT = (8, 11)
NECK_CHANNELS = (256, 512, 768, 768)
FUSION = 256
PRETRAIN_GRID = 24  # 384 / 16
HEAD_MID = 32


def tf_same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW `x` for a k×k window of stride s as TF's SAME does."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: width, then height
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class WSConv(nn.Conv2d):
    """Weight-standardized conv (HF WeightStandardizedConv2d, eps 1e-8), no
    bias, TF-SAME padding: each output channel's kernel is normalised to
    zero mean and unit (population) variance in f32 at call time."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1) -> None:
        super().__init__(in_channels, out_channels, kernel, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + 1e-8)).to(x.dtype)
        k, s = self.kernel_size[0], self.stride[0]
        y = F.conv2d(tf_same_pad(x.permute(0, 3, 1, 2), k, s), w, stride=s)
        return y.permute(0, 2, 3, 1)


class GroupNormAct(nn.Module):
    """GroupNorm (eps 1e-5) on NHWC, then ReLU unless `act` is False."""

    def __init__(self, channels: int, act: bool = True, groups: int = 32) -> None:
        super().__init__()
        self.act = act
        self.norm = nn.GroupNorm(groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.relu(x) if self.act else x


def _make_div(v: int, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class BitBottleneck(nn.Module):
    """Non-preactivation bottleneck (HF BitBottleneckLayer)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 is_first: bool = False, groups: int = 32) -> None:
        super().__init__()
        mid = _make_div(int(out_channels * 0.25))
        if is_first:
            self.downsample_conv = WSConv(in_channels, out_channels, 1, stride)
            self.downsample_norm = GroupNormAct(out_channels, act=False, groups=groups)
        self.conv1 = WSConv(in_channels, mid, 1)
        self.norm1 = GroupNormAct(mid, groups=groups)
        self.conv2 = WSConv(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid, groups=groups)
        self.conv3 = WSConv(mid, out_channels, 1)
        self.norm3 = GroupNormAct(out_channels, act=False, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if hasattr(self, "downsample_conv"):
            shortcut = self.downsample_norm(self.downsample_conv(x))
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class BitStem(nn.Module):
    def __init__(self, embed: int = BIT_EMBED, groups: int = 32) -> None:
        super().__init__()
        self.conv = WSConv(3, embed, 7, 2)
        self.norm = GroupNormAct(embed, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.conv(x)).permute(0, 3, 1, 2)
        # TF-SAME 3x3 stride-2 max pool, padded with -inf
        h = F.max_pool2d(tf_same_pad(h, 3, 2, float("-inf")), 3, 2)
        return h.permute(0, 2, 3, 1)


class BitBackbone(nn.Module):
    """3-stage BiT; returns the three stages' maps, strides 4, 8 and 16.
    Layer l of stage s is the attribute `stage{s}_layer{l}`."""

    def __init__(self, depths: Tuple[int, ...] = BIT_DEPTHS,
                 hidden: Tuple[int, ...] = BIT_HIDDEN, embed: int = BIT_EMBED,
                 groups: int = 32) -> None:
        super().__init__()
        self.stem = BitStem(embed, groups)
        self.stage_names = []
        cin = embed
        for s, (depth, h) in enumerate(zip(depths, hidden)):
            out_ch = _make_div(h)
            names = []
            for l in range(depth):
                name = f"stage{s}_layer{l}"
                stride = (1 if s == 0 else 2) if l == 0 else 1
                setattr(self, name, BitBottleneck(cin, out_ch, stride, is_first=l == 0,
                                                  groups=groups))
                names.append(name)
                cin = out_ch
            self.stage_names.append(names)

    def forward(self, pixels: torch.Tensor):
        h = self.stem(pixels)
        feats = []
        for names in self.stage_names:
            for name in names:
                h = getattr(self, name)(h)
            feats.append(h)
        return feats


class DPTHybrid(nn.Module):
    """pixels [B,H,W,3] (normalized, mean = std = 0.5) → MiDaS disparity
    [B,h',w'] at the head's resolution.  `quant=True` makes the ViT layers'
    products int8 (the BiT stem and the decoder stay float).  Its ViT
    layers sit at the top level, so `tp_scopes` names them for tensor
    parallelism."""

    tp_scopes = ("layer",)

    def __init__(self, patch_size: int = 16, bit_depths: Tuple[int, ...] = BIT_DEPTHS,
                 bit_hidden: Tuple[int, ...] = BIT_HIDDEN, bit_embed: int = BIT_EMBED,
                 bit_groups: int = 32, vit_hidden: int = VIT_HIDDEN,
                 vit_layers: int = VIT_LAYERS, vit_heads: int = VIT_HEADS,
                 vit_mlp: int = VIT_MLP, vit_out: Tuple[int, ...] = VIT_OUT,
                 neck_channels: Tuple[int, ...] = NECK_CHANNELS, fusion: int = FUSION,
                 pretrain_grid: int = PRETRAIN_GRID, quant: bool = False) -> None:
        super().__init__()
        D = vit_hidden
        self.patch_size = patch_size
        self.pretrain_grid = pretrain_grid
        self.vit_out = tuple(vit_out)
        self.hidden = D
        self.bit = BitBackbone(bit_depths, bit_hidden, bit_embed, bit_groups)
        bit_ch = [_make_div(h) for h in bit_hidden]
        self.projection = Conv(bit_ch[2], D, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.position_embeddings = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1, D))
        self.layer = nn.ModuleList(
            ViTLayer(D, vit_heads, vit_mlp, quant) for _ in range(vit_layers))
        # stages 2 and 3: readout projection + reassemble (identity, stride-2 conv)
        self.readout = nn.ModuleDict({str(i): nn.Linear(2 * D, D) for i in (2, 3)})
        self.reassemble = nn.ModuleDict({
            "2": ReassembleLayer(D, neck_channels[2], 1),
            "3": ReassembleLayer(D, neck_channels[3], -2)})
        stage_ch = (bit_ch[0], bit_ch[1], neck_channels[2], neck_channels[3])
        self.conv = nn.ModuleList(Conv(c, fusion, 3, padding=1, bias=False) for c in stage_ch)
        self.fusion = nn.ModuleList(
            FeatureFusionLayer(fusion, with_residual=j > 0) for j in range(4))
        self.head_conv1 = Conv(fusion, fusion // 2, 3, padding=1)
        self.head_conv2 = Conv(fusion // 2, HEAD_MID, 3, padding=1)
        self.head_conv3 = Conv(HEAD_MID, 1, 1)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "DPTHybrid":
        return cls(patch_size=spec.patch_size, quant=quant)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = pixels.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        f1, f2, f3 = self.bit(pixels)
        tokens = self.projection(f3).reshape(B, gh * gw, self.hidden)
        x = with_cls(tokens, self.cls_token,
                     position_table(self.position_embeddings, gh, gw, self.pretrain_grid))
        vit_feats = []
        for i, layer in enumerate(self.layer):
            x = layer(x)
            if i in self.vit_out:
                vit_feats.append(x)
        stages = [f1, f2] + [self.reassemble[si](readout_grid(f, self.readout[si], gh, gw))
                             for si, f in zip(("2", "3"), vit_feats)]
        rn = [conv(s) for conv, s in zip(self.conv, stages)]
        return classic_head(self, fuse(rn, self.fusion)[-1])[0]
