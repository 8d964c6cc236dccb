"""InfiniDepth: a DINOv3 trunk, an f32 conv stem and an implicit MLP head.

Port of `desktop2stereo_tpu/models/infinidepth.py` (the reference's
InfiniDepth runtime path on the vendored DINOv3 ViT).  The model takes RGB
in [0, 1] and normalises it itself (`norm_family="none"`), and returns
relative depth at its input's resolution:

- the trunk: patch 16, a cls token and 4 storage tokens before the patch
  tokens, pre-norm blocks (LayerNorm eps 1e-5, LayerScale, GELU MLP or, for
  SmallPlus, a SwiGLU with separate `w1` / `w2` gates and `w3`), axial RoPE
  (base 100) on the patch tokens of q and k only.  The RoPE tables are numpy
  constants per grid, put on the device once; q and k leave the rotation as
  fresh contiguous [B, N, H, 64] tensors and v stays a strided view of the
  fused qkv product, layouts the attention kernel (K2) reads as they are;
- `BasicEncoder`: a 4-scale ResNet stem with affine-free InstanceNorm, run
  in float32 whatever the model's dtype (`F32Module`), as the JAX module
  runs it;
- `ImplicitHead`: both feature maps resized bilinearly to the input's size
  (weight-matrix resizes) times a border mask that turns the clamp-to-edge
  resize into grid_sample's zero padding, concatenated, then an MLP over
  the pixels and an ELU.

Module and parameter names follow the JAX tree.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.core.runtime import F32Module
from desktop2stereo_tpu_torch.models.dinov2 import _dense
from desktop2stereo_tpu_torch.models.dpt import Conv
from desktop2stereo_tpu_torch.models.dpt_vit import patch_tokens
from desktop2stereo_tpu_torch.ops.activations import gelu
from desktop2stereo_tpu_torch.ops.attention import multi_head_attention
from desktop2stereo_tpu_torch.ops.resize import resize

# encoder → (embed dim, depth, heads, FFN hidden, SwiGLU)
DINOV3_CONFIGS = {
    "vits16": (384, 12, 6, 1536, False),
    "vits16plus": (384, 12, 6, 2304, True),
    "vitb16": (768, 12, 12, 3072, False),
    "vitl16": (1024, 24, 16, 4096, False),
}
# registry name → encoder
ENCODER_BY_NAME = {
    "InfiniDepth-Small": "vits16",
    "InfiniDepth-SmallPlus": "vits16plus",
    "InfiniDepth-Base": "vitb16",
    "InfiniDepth-Large": "vitl16",
}
N_STORAGE_TOKENS = 4
N_PREFIX = 1 + N_STORAGE_TOKENS
PATCH = 16
LN_EPS = 1e-5
ROPE_BASE = 100.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HIDDEN_LIST = (1024, 256, 32)
BASIC_DIM = 128


def dinov3_rope_tables(head_dim: int, gh: int, gw: int) -> Tuple[np.ndarray, np.ndarray]:
    """Axial RoPE sin and cos [gh·gw, head_dim] (eval: coordinates in
    [-1, 1] separately per axis, no shift, jitter or rescale)."""
    quarter = head_dim // 4
    periods = ROPE_BASE ** (2 * np.arange(quarter, dtype=np.float64) / (head_dim // 2))
    ys = (2.0 * (np.arange(gh, dtype=np.float64) + 0.5) / gh) - 1.0
    xs = (2.0 * (np.arange(gw, dtype=np.float64) + 0.5) / gw) - 1.0
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=1)
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = np.tile(angles.reshape(-1, 2 * quarter), (1, 2))
    return np.sin(angles).astype(np.float32), np.cos(angles).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rope_on(head_dim: int, gh: int, gw: int, device: torch.device,
             dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tables as [1, gh·gw, 1, head_dim] tensors on `device` in `dtype`,
    built once per grid (outside inference mode, so that they serve callers
    in or out of it)."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t)[None, :, None, :].to(device=device, dtype=dtype)
                     for t in dinov3_rope_tables(head_dim, gh, gw))


def rope_apply(t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """t [B, N, H, hd]: the patch tokens rotated ([x1, x2] → [-x2, x1] over
    the whole head dim), the cls and storage tokens as they are; a fresh
    contiguous tensor."""
    prefix, patches = t[:, :N_PREFIX], t[:, N_PREFIX:]
    half = t.shape[-1] // 2
    rotated = torch.cat([-patches[..., half:], patches[..., :half]], dim=-1)
    return torch.cat([prefix, patches * cos + rotated * sin], dim=1)


def swiglu_width(ffn_hidden: int) -> int:
    """DINOv3's SwiGLU hidden width: int(ffn · 2/3) aligned up to 8."""
    d = int(ffn_hidden * 2 / 3)
    return d + (-d % 8)


class Dinov3Block(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, ffn_hidden: int,
                 use_swiglu: bool = False, quant: bool = False) -> None:
        super().__init__()
        D = hidden_size
        self.num_heads = num_heads
        self.use_swiglu = use_swiglu
        self.norm1 = nn.LayerNorm(D, eps=LN_EPS)
        self.qkv = _dense(D, 3 * D, quant)
        self.proj = _dense(D, D, quant)
        self.layer_scale1 = nn.Parameter(torch.ones(D))
        self.norm2 = nn.LayerNorm(D, eps=LN_EPS)
        if use_swiglu:
            sw = swiglu_width(ffn_hidden)
            self.w1 = _dense(D, sw, quant)
            self.w2 = _dense(D, sw, quant)
            self.w3 = _dense(sw, D, quant)
        else:
            self.fc1 = _dense(D, ffn_hidden, quant)
            self.fc2 = _dense(ffn_hidden, D, quant)
        self.layer_scale2 = nn.Parameter(torch.ones(D))

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        q, k, v = (t.unflatten(-1, (self.num_heads, D // self.num_heads))
                   for t in self.qkv(self.norm1(x)).split(D, dim=-1))
        attn = multi_head_attention(rope_apply(q, sin, cos), rope_apply(k, sin, cos), v)
        x = x + self.proj(attn.reshape(B, N, D)) * self.layer_scale1.to(x.dtype)
        h = self.norm2(x)
        if self.use_swiglu:
            h = self.w3(F.silu(self.w1(h)) * self.w2(h))
        else:
            h = self.fc2(gelu(self.fc1(h)))
        return x + h * self.layer_scale2.to(x.dtype)


class Dinov3Backbone(nn.Module):
    """pixels [B,H,W,3] (ImageNet-normalised) → the last block's patch
    tokens, normed, [B, gh·gw, D]."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int, ffn_hidden: int,
                 use_swiglu: bool = False, quant: bool = False) -> None:
        super().__init__()
        D = embed_dim
        self.head_dim = D // num_heads
        self.patch_kernel = nn.Parameter(torch.empty(PATCH * PATCH * 3, D))
        self.patch_bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.storage_tokens = nn.Parameter(torch.zeros(1, N_STORAGE_TOKENS, D))
        self.layer = nn.ModuleList(Dinov3Block(D, num_heads, ffn_hidden, use_swiglu, quant)
                                   for _ in range(depth))
        self.norm = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B = pixels.shape[0]
        gh, gw = pixels.shape[1] // PATCH, pixels.shape[2] // PATCH
        x = patch_tokens(pixels, self.patch_kernel, self.patch_bias, PATCH)
        prefix = torch.cat([self.cls_token, self.storage_tokens], dim=1)
        x = torch.cat([prefix.to(x.dtype).expand(B, -1, -1), x], dim=1)
        sin, cos = _rope_on(self.head_dim, gh, gw, x.device, x.dtype)
        for layer in self.layer:
            x = layer(x, sin, cos)
        return self.norm(x)[:, N_PREFIX:]


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False, eps 1e-5) on NHWC."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = Conv(in_channels, planes, 3, stride=stride, padding=1)
        self.conv2 = Conv(planes, planes, 3, padding=1)
        self.downsample = Conv(in_channels, planes, 1, stride=stride) if stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(F32Module):
    """The 4-scale instance-norm ResNet stem → BASIC_DIM channels at stride
    4, in float32."""

    def __init__(self) -> None:
        super().__init__()
        od = BASIC_DIM
        widths = (od // 2, od // 4 * 3, od, od)
        self.conv1 = Conv(3, od // 2, 7, stride=2, padding=3)
        cin = od // 2
        for li, (w, stride) in enumerate(zip(widths, (1, 2, 2, 2)), 1):
            setattr(self, f"layer{li}", nn.ModuleList(
                [ResidualBlock(cin, w, stride), ResidualBlock(w, w, 1)]))
            cin = w
        self.conv2 = Conv(sum(widths), 2 * od, 3, padding=1)
        self.conv3 = Conv(2 * od, od, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        x = F.relu(instance_norm(self.conv1(x)))
        scales = []
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x)
            scales.append(resize(x, (H // 4, W // 4), mode="bilinear", align_corners=True))
        x = F.relu(instance_norm(self.conv2(torch.cat(scales, dim=-1))))
        return self.conv3(x)


def zero_padding_mask(in_h: int, in_w: int, out_h: int, out_w: int) -> np.ndarray:
    """[out_h, out_w] border weights that make a clamp-to-edge bilinear
    upsample equal grid_sample's zero padding."""
    yy = (np.arange(out_h, dtype=np.float64) + 0.5) * (in_h / out_h) - 0.5
    xx = (np.arange(out_w, dtype=np.float64) + 0.5) * (in_w / out_w) - 0.5
    wy = np.clip(np.where(yy < 0, yy + 1.0, np.where(yy > in_h - 1, in_h - yy, 1.0)), 0.0, 1.0)
    wx = np.clip(np.where(xx < 0, xx + 1.0, np.where(xx > in_w - 1, in_w - xx, 1.0)), 0.0, 1.0)
    return (wy[:, None] * wx[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _mask_on(in_h: int, in_w: int, out_h: int, out_w: int, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(zero_padding_mask(in_h, in_w, out_h, out_w))[
            None, :, :, None].to(device=device, dtype=dtype)


class ImplicitHead(nn.Module):
    """Both feature maps sampled densely at the output size, concatenated,
    an MLP [1024, 256, 32] → 1 over the pixels, ELU."""

    def __init__(self, in_features: int) -> None:
        super().__init__()
        widths = (in_features, *HIDDEN_LIST)
        self.mlp = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.mlp_out = nn.Linear(widths[-1], 1)

    @staticmethod
    def dense_sample(f: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
        up = resize(f, out_hw, mode="bilinear")
        return up * _mask_on(f.shape[1], f.shape[2], *out_hw, up.device, up.dtype)

    def forward(self, dino_feat: torch.Tensor, basic_feat: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
        h = torch.cat([self.dense_sample(dino_feat, out_hw),
                       self.dense_sample(basic_feat, out_hw)], dim=-1)
        for layer in self.mlp:
            h = F.relu(layer(h))
        return F.elu(self.mlp_out(h))[..., 0]


class InfiniDepth(nn.Module):
    """pixels [B,H,W,3] RGB in [0, 1] → relative depth [B,H,W].  `quant=True`
    makes the trunk's dense products int8 (K4); the stem and head stay
    float."""

    def __init__(self, encoder: str = "vitl16", quant: bool = False) -> None:
        super().__init__()
        D, depth, heads, ffn, swiglu = DINOV3_CONFIGS[encoder]
        self.backbone = Dinov3Backbone(D, depth, heads, ffn, swiglu, quant=quant)
        self.basic_encoder = BasicEncoder()
        self.head = ImplicitHead(D + BASIC_DIM)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "InfiniDepth":
        return cls(ENCODER_BY_NAME[spec.name], quant=quant)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = pixels.shape
        mean = torch.tensor(IMAGENET_MEAN, dtype=pixels.dtype, device=pixels.device)
        std = torch.tensor(IMAGENET_STD, dtype=pixels.dtype, device=pixels.device)
        tokens = self.backbone((pixels - mean) / std)
        dino = tokens.reshape(B, H // PATCH, W // PATCH, -1)
        basic = self.basic_encoder((2.0 * pixels - 1.0).float())
        return self.head(dino, basic.to(dino.dtype), (H, W))
