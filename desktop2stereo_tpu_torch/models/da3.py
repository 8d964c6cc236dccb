"""Depth-Anything-3: a DINOv2 trunk with QK-norm, 2D RoPE, alternating
intra-/cross-view attention and a camera token, under a DualDPT head (depth,
confidence, rays, and a camera decoder) or a DPT head with a sky mask.

Port of `desktop2stereo_tpu/models/da3.py`, with the same class names and the
parameter tree's names, so `from_flax` maps it mechanically.  The view axis
S stays first-class: pixels [B, S, H, W, 3] (or [B, H, W, 3], one view);
local layers attend over [B·S, N] tokens and global ones over [B, S·N], the
same batched attention either way (K2, `ops/attention.py`).

`predict(pixels, outputs)` computes the outputs named and nothing else: the
JAX package leaves the unused branches to XLA's dead-code elimination, and
eager PyTorch would otherwise run them on every frame.  `forward(pixels)` is
the frame's depth [B, H, W] (`da3_depth_apply`): the anyview presets run the
trunk and the depth branch of the DualDPT, never the ray branch or the camera
decoder; the mono and metric presets add the sky head and fill the sky with
the far depth.  `DA3Nested` (DA3NESTED-GIANT-LARGE) runs a ViT-G anyview
branch and a ViT-L metric branch and aligns the first onto the second by
least squares (`nested_align`), which needs the anyview branch's confidence
and camera pose but not its rays.

The RoPE tables and the DualDPT's UV positional fields are built with numpy
in f64 (as the JAX package builds its trace-time constants), cast to the
compute dtype and uploaded once per shape and device.  The RoPE rotation
runs in the tensors' dtype, after the cast, as JAX's `_apply_rope` does.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.core.registry import (
    VIT_VARIANTS, ModelSpec, da3_mode, is_da3_nested)
from desktop2stereo_tpu_torch.models.dinov2 import (
    LN_EPS, PRETRAIN_GRID, _dense, swiglu, swiglu_hidden)
from desktop2stereo_tpu_torch.models.dpt import (
    HEAD_CHANNELS, Conv, ConvTransposeSameStride, FeatureFusionLayer)
from desktop2stereo_tpu_torch.ops.activations import gelu
from desktop2stereo_tpu_torch.ops.attention import multi_head_attention
from desktop2stereo_tpu_torch.ops.resize import resize

# Per-variant presets: (out_layers, alt_start, neck_channels, fusion_channels)
DA3_PRESETS = {
    "vits": ((5, 7, 9, 11), 4, (48, 96, 192, 384), 64),
    "vitb": ((5, 7, 9, 11), 4, (96, 192, 384, 768), 128),
    "vitl": ((11, 15, 19, 23), 8, (256, 512, 1024, 1024), 256),
    "vitg": ((19, 27, 33, 39), 13, (256, 512, 1024, 1024), 256),
}
# The mono and metric presets' out layers (a single-branch DPT)
DA3_MONO_OUT_LAYERS = (4, 11, 17, 23)

ROPE_FREQ = 100.0
POS_EMBED_OMEGA = 100.0
QK_NORM_EPS = 1e-5   # torch LayerNorm(head_dim) default
HEAD_LN_EPS = 1e-5
POS_OFFSET = 0.1     # DA3 keeps DINOv2's offset-0.1 position-table interpolation

ANYVIEW_OUTPUTS = ("depth", "depth_conf", "ray", "ray_conf", "pose_enc")
SINGLE_OUTPUTS = ("depth", "sky")
DUAL_MAIN_CHANNELS = 2  # DualDPT main logits: depth, confidence
DUAL_AUX_CHANNELS = 7   # DualDPT aux logits: ray (6), confidence

# The sky post: sky ≥ SKY_THRESHOLD is sky; it takes the SKY_QUANTILE of the
# non-sky depth (capped at NESTED_SKY_DEPTH_CAP under NESTED) unless either
# class has at most SKY_MIN_PIXELS pixels (mono and metric presets)
SKY_THRESHOLD = 0.3
SKY_QUANTILE = 0.99
SKY_MIN_PIXELS = 10
NESTED_SKY_DEPTH_CAP = 200.0


# ---------------------------------------------------------------------------
# Positional helpers (numpy in f64, returned f32), and their device copies
# ---------------------------------------------------------------------------

def _rope_tables(head_dim: int, positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [N, head_dim] for 2D RoPE: the first half of the head dim
    rotates by y, the second by x; within each half the pairs are
    (i, i + quarter)."""
    half = head_dim // 2
    inv_freq = 1.0 / (ROPE_FREQ ** (np.arange(0, half, 2, dtype=np.float64) / half))

    def table(pos_1d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        angles = np.einsum("n,f->nf", pos_1d.astype(np.float64), inv_freq)
        angles = np.concatenate([angles, angles], axis=-1)  # [N, half]
        return np.cos(angles), np.sin(angles)

    cy, sy = table(positions[:, 0])
    cx, sx = table(positions[:, 1])
    cos = np.concatenate([cy, cx], axis=-1).astype(np.float32)
    sin = np.concatenate([sy, sx], axis=-1).astype(np.float32)
    return cos, sin


def _grid_positions(gh: int, gw: int, n_special: int = 1) -> np.ndarray:
    """Token positions: the special tokens at (0, 0), patch (y, x) at
    (y + 1, x + 1)."""
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    patch = np.stack([yy.reshape(-1) + 1, xx.reshape(-1) + 1], axis=1)
    special = np.zeros((n_special, 2), dtype=patch.dtype)
    return np.concatenate([special, patch], axis=0)


def _uv_pos_embed(h: int, w: int, channels: int, aspect: float) -> np.ndarray:
    """The UV sinusoidal field [h, w, channels], times 0.1."""
    diag = math.sqrt(aspect * aspect + 1.0)
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = np.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w)
    ys = np.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h)
    uu, vv = np.meshgrid(xs, ys)  # [h, w]

    def embed(pos: np.ndarray, dim: int) -> np.ndarray:
        omega = 1.0 / (POS_EMBED_OMEGA ** (np.arange(dim // 2, dtype=np.float64) / (dim // 2)))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    half = channels // 2
    emb = np.concatenate([embed(uu, half), embed(vv, half)], axis=-1)
    return (emb.reshape(h, w, channels) * 0.1).astype(np.float32)


def _upload(a: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # made outside inference mode, so that a table first built under
    # torch.inference_mode also serves callers outside it
    with torch.inference_mode(False):
        return torch.from_numpy(a).to(device, dtype)


def _rotation_sign(head_dim: int) -> np.ndarray:
    """[hd] f32: -1 on the first quarter of each half of the head dim, +1 on
    the second (rot takes (u1, u2) to (-u2, u1) within each half)."""
    quarter = head_dim // 4
    return np.tile(np.repeat(np.float32([-1.0, 1.0]), quarter), 2)


@functools.lru_cache(maxsize=32)
def _rope(head_dim: int, gh: int, gw: int, views: int, local: bool,
          device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin · `_rotation_sign`) [N, hd] of one grid on `device` in
    `dtype`, the tables `_apply_rope` takes.  Local: the real 2D
    coordinates of one view's N tokens.  Global: every patch at (1, 1) and
    the special token at (0, 0), tiled over the S views the global layers
    attend across."""
    if local:
        pos = _grid_positions(gh, gw)
    else:
        pos = np.concatenate([np.zeros((1, 2), np.int64), np.ones((gh * gw, 2), np.int64)])
    cos, sin = _rope_tables(head_dim, pos)
    if not local:
        cos, sin = np.tile(cos, (views, 1)), np.tile(sin, (views, 1))
    return _upload(cos, device, dtype), _upload(sin * _rotation_sign(head_dim), device, dtype)


@functools.lru_cache(maxsize=32)
def _uv_table(h: int, w: int, channels: int, aspect: float,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`_uv_pos_embed` on `device` in `dtype`, built once per shape."""
    return _upload(_uv_pos_embed(h, w, channels, aspect), device, dtype)


def _apply_rope(t: torch.Tensor, cos: torch.Tensor, sin_rot: torch.Tensor) -> torch.Tensor:
    """t [B, N, H, hd] → t·cos + rot(t)·sin, where rot takes each quarter
    pair (u1, u2) of the y and x halves to (-u2, u1).  rot(t)·sin is the
    pairs swapped times `sin_rot` (sin with the sign folded in, exact), so
    each product rounds where JAX's `_apply_rope` rounds.  cos/sin_rot
    [N, hd] in t's dtype, from `_rope`."""
    swapped = t.unflatten(-1, (2, 2, t.shape[-1] // 4)).flip(-2).flatten(-3)
    return t * cos[None, :, None, :] + swapped * sin_rot[None, :, None, :]


# ---------------------------------------------------------------------------
# Trunk
# ---------------------------------------------------------------------------

class DA3Attention(nn.Module):
    """Fused qkv, optional per-head LayerNorm on q and k, 2D RoPE, K2, proj.
    Under QK-norm or RoPE q and k reach K2 as fresh contiguous tensors; v
    stays a strided view of the qkv product.  The head count and width come
    from the module: under tensor parallelism this rank holds `num_heads` =
    H/tp heads of a head-split qkv and a row-parallel proj, and K2 runs on
    its local heads (the JAX package: the shard_map of
    `ops/attention.py:71`; the qkv split by heads, not contiguously as JAX
    splits it, so a rank's q, k and v are whole heads).  QK-norm (over hd)
    and RoPE (per head) act head by head, so they are local as they stand."""

    def __init__(self, hidden_size: int, num_heads: int, qk_norm: bool = False,
                 quant: bool = False) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hd = hidden_size // num_heads
        self.qkv = _dense(hidden_size, 3 * hidden_size, quant)
        self.proj = _dense(hidden_size, hidden_size, quant)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = nn.LayerNorm(hd, eps=QK_NORM_EPS)
            self.k_norm = nn.LayerNorm(hd, eps=QK_NORM_EPS)

    def forward(self, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        B, N, _ = x.shape
        width = self.num_heads * self.head_dim
        q, k, v = (t.unflatten(-1, (self.num_heads, self.head_dim))
                   for t in self.qkv(x).split(width, dim=-1))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q, k = _apply_rope(q, *rope), _apply_rope(k, *rope)
        return self.proj(multi_head_attention(q, k, v).reshape(B, N, width))


class DA3Mlp(nn.Module):
    """GELU fc1/fc2, or ViT-G's SwiGLU (dinov2's) in DA3's naming, w12 / w3.
    Under tensor parallelism `w12` is split pair by pair (the same hidden
    indices of x1 and x2 on a rank; the JAX package splits it contiguously
    and GSPMD pairs the halves), `fc1` column- and `fc2` / `w3` row-parallel
    (the JAX int8 shard_maps: `ops/quant.py:129/152`)."""

    def __init__(self, hidden_size: int, mlp_dim: int, use_swiglu: bool = False,
                 quant: bool = False) -> None:
        super().__init__()
        self.use_swiglu = use_swiglu
        if use_swiglu:
            hidden = swiglu_hidden(mlp_dim)
            self.w12 = _dense(hidden_size, 2 * hidden, quant)
            self.w3 = _dense(hidden, hidden_size, quant)
        else:
            self.fc1 = _dense(hidden_size, mlp_dim, quant)
            self.fc2 = _dense(mlp_dim, hidden_size, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_swiglu:
            return swiglu(x, self.w12, self.w3)
        return self.fc2(gelu(self.fc1(x)))


class DA3Block(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int, qk_norm: bool = False,
                 use_swiglu: bool = False, quant: bool = False) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.attention = DA3Attention(hidden_size, num_heads, qk_norm, quant)
        self.layer_scale1 = nn.Parameter(torch.ones(hidden_size))
        self.norm2 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.mlp = DA3Mlp(hidden_size, mlp_dim, use_swiglu, quant)
        self.layer_scale2 = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), rope) * self.layer_scale1.to(x.dtype)
        return x + self.mlp(self.norm2(x)) * self.layer_scale2.to(x.dtype)


class DA3Backbone(nn.Module):
    """The DA3 DINOv2 trunk.  forward(pixels [B, S, H, W, 3]) →
    (feats, cam_tokens): per out layer, patch tokens [B, S, N-1, C_out] and
    the slot-0 token [B, S, C_out].  From `alt_start` on (the anyview
    presets), slot 0 holds the camera token, every layer runs QK-norm and
    RoPE, the odd layers attend across views, and C_out = 2·hidden
    (`cat_token`: the last local layer's tokens beside the current ones, the
    final norm on the second half only).  alt_start = -1 (the mono and
    metric presets) turns all of these off: C_out = hidden."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int, mlp_dim: int,
                 out_layers: Tuple[int, ...], alt_start: int = -1, patch_size: int = 14,
                 use_swiglu: bool = False, quant: bool = False) -> None:
        super().__init__()
        D, p = hidden_size, patch_size
        self.hidden_size, self.num_heads, self.patch_size = D, num_heads, p
        self.out_layers = tuple(out_layers)
        self.alt_start, self.cat_token = alt_start, alt_start != -1
        self.patch_kernel = nn.Parameter(torch.empty(p * p * 3, D))  # (p_h, p_w, c) × D
        self.patch_bias = nn.Parameter(torch.zeros(D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, PRETRAIN_GRID ** 2 + 1, D))
        if alt_start != -1:
            self.camera_token = nn.Parameter(torch.zeros(1, 2, D))  # (reference, source)
        self.layer = nn.ModuleList(
            DA3Block(D, num_heads, mlp_dim, qk_norm=self.cat_token and i >= alt_start,
                     use_swiglu=use_swiglu, quant=quant) for i in range(num_layers))
        self.norm = nn.LayerNorm(D, eps=LN_EPS)

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, S, H, W, 3] → tokens [B, S, N, D] (cls + patches, with
        the position table interpolated at scale (g + 0.1) / 37)."""
        B, S, H, W, _ = pixels.shape
        p, D, M = self.patch_size, self.hidden_size, PRETRAIN_GRID
        gh, gw = H // p, W // p
        x = pixels.reshape(B * S, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = F.linear(x.reshape(B * S, gh * gw, p * p * 3), self.patch_kernel.t().to(x.dtype),
                     self.patch_bias.to(x.dtype))
        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (M, M):
            grid = patch_pos.reshape(M, M, D).float()
            grid = resize(grid, (gh, gw), mode="bicubic",
                          scale_override=((gh + POS_OFFSET) / M, (gw + POS_OFFSET) / M))
            patch_pos = grid.reshape(1, gh * gw, D)
        pos = torch.cat([cls_pos.float(), patch_pos.float()], dim=1).to(x.dtype)
        x = torch.cat([self.cls_token.to(x.dtype).expand(B * S, 1, D), x], dim=1) + pos
        return x.reshape(B, S, gh * gw + 1, D)

    def forward(self, pixels: torch.Tensor):
        B, S, H, W, _ = pixels.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        D = self.hidden_size
        x = self.embed(pixels)
        N = x.shape[2]
        rope_local = rope_global = None
        if self.cat_token:
            hd = D // self.num_heads
            rope_local = _rope(hd, gh, gw, 1, True, x.device, x.dtype)
            rope_global = _rope(hd, gh, gw, S, False, x.device, x.dtype)

        feats = []
        last_local = x
        for i, block in enumerate(self.layer):
            if i == self.alt_start:
                # the camera token takes slot 0: the reference view's token
                # alone for one view, the mean of both for several
                ct = self.camera_token
                cam = (ct[:, :1] + ct[:, 1:2]) / 2.0 if S > 1 else ct[:, :1]
                cam = cam.to(x.dtype).reshape(1, 1, 1, D).expand(B, S, 1, D)
                x = torch.cat([cam, x[:, :, 1:]], dim=2)
            alternating = self.cat_token and i >= self.alt_start
            if alternating and i % 2 == 1:
                x = block(x.reshape(B, S * N, D), rope_global).reshape(B, S, N, D)
            else:
                x = block(x.reshape(B * S, N, D), rope_local if alternating else None)
                x = last_local = x.reshape(B, S, N, D)
            if i in self.out_layers:
                feats.append(torch.cat([last_local, x], dim=-1) if self.cat_token else x)

        outs, cam_tokens = [], []
        for f in feats:
            cam_tokens.append(f[:, :, 0])  # taken before the final norm
            if self.cat_token:
                f = torch.cat([f[..., :D], self.norm(f[..., D:])], dim=-1)
            else:
                f = self.norm(f)
            outs.append(f[:, :, 1:])
        return tuple(outs), tuple(cam_tokens)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

class _DA3Reassemble(nn.Module):
    """Per stage: token LayerNorm (DualDPT; identity in DPT) → 1x1 project
    (+ the UV field, DualDPT) → ×4 / ×2 conv-transpose, identity, or a
    stride-2 conv.  The `resize` list holds an Identity at stage 2."""

    def __init__(self, dim_in: int, neck_channels: Sequence[int], use_norm: bool,
                 pos_embed: bool) -> None:
        super().__init__()
        self.neck_channels = tuple(neck_channels)
        self.pos_embed = pos_embed
        self.norm = nn.LayerNorm(dim_in, eps=HEAD_LN_EPS) if use_norm else None
        self.project = nn.ModuleList(Conv(dim_in, c, 1) for c in neck_channels)
        c0, c1, _, c3 = neck_channels
        self.resize = nn.ModuleList([ConvTransposeSameStride(c0, c0, 4),
                                     ConvTransposeSameStride(c1, c1, 2), nn.Identity(),
                                     Conv(c3, c3, 3, stride=2, padding=1)])

    def forward(self, feats: Sequence[torch.Tensor], gh: int, gw: int, aspect: float):
        out = []
        for i, f in enumerate(feats):
            if self.norm is not None:
                f = self.norm(f)
            g = self.project[i](f.reshape(f.shape[0], gh, gw, f.shape[2]))
            if self.pos_embed:
                g = g + _uv_table(gh, gw, self.neck_channels[i], aspect, g.device, g.dtype)
            out.append(self.resize[i](g))
        return out


class _FusionChain(nn.Module):
    """The refinenet 4→1 chain over the four neck maps, coarsest first; its
    layers are `fusion<suffix>` as the parameter tree names them."""

    def __init__(self, channels: int, suffix: str = "") -> None:
        super().__init__()
        self.attr = "fusion" + suffix
        setattr(self, self.attr, nn.ModuleList(
            FeatureFusionLayer(channels, with_residual=j > 0) for j in range(4)))

    def forward(self, rn: Sequence[torch.Tensor]) -> torch.Tensor:
        l1, l2, l3, l4 = rn
        sizes = [(l3.shape[1], l3.shape[2]), (l2.shape[1], l2.shape[2]),
                 (l1.shape[1], l1.shape[2]), (l1.shape[1] * 2, l1.shape[2] * 2)]
        layers = getattr(self, self.attr)
        fused = layers[0](l4, None, sizes[0])
        for layer, lateral, size in zip(layers[1:], (l3, l2, l1), sizes[1:]):
            fused = layer(fused, lateral, size)
        return fused


def _neck_convs(neck_channels: Sequence[int], fusion_channels: int) -> nn.ModuleList:
    return nn.ModuleList(Conv(c, fusion_channels, 3, padding=1, bias=False)
                         for c in neck_channels)


class DA3DualDPT(nn.Module):
    """DualDPT: the main chain (depth and its confidence) and the aux chain
    (rays and their confidence), over shared reassembled neck maps; depth is
    exp of its logit, each confidence exp + 1.  forward(feats, H, W,
    outputs) computes the aux chain only when "ray" or "ray_conf" is asked
    for, and the confidence only when "depth_conf" is."""

    def __init__(self, dim_in: int, neck_channels: Sequence[int], fusion_channels: int,
                 patch_size: int = 14) -> None:
        super().__init__()
        fc = fusion_channels
        self.patch_size, self.fusion_channels = patch_size, fc
        self.reassemble = _DA3Reassemble(dim_in, neck_channels, use_norm=True, pos_embed=True)
        self.conv = _neck_convs(neck_channels, fc)
        self.main = _FusionChain(fc)
        self.head_conv1 = Conv(fc, fc // 2, 3, padding=1)
        self.head_conv2 = Conv(fc // 2, HEAD_CHANNELS, 3, padding=1)
        self.head_conv3 = Conv(HEAD_CHANNELS, DUAL_MAIN_CHANNELS, 1)
        self.aux = _FusionChain(fc, suffix="_aux")
        widths = (fc // 2, fc, fc // 2, fc, fc // 2)
        self.aux_conv1 = nn.ModuleList(Conv(c_in, c_out, 3, padding=1)
                                       for c_in, c_out in zip((fc,) + widths[:-1], widths))
        self.aux_conv2 = Conv(fc // 2, HEAD_CHANNELS, 3, padding=1)
        self.aux_ln = nn.LayerNorm(HEAD_CHANNELS, eps=HEAD_LN_EPS)
        self.aux_conv3 = Conv(HEAD_CHANNELS, DUAL_AUX_CHANNELS, 1)

    def _aux(self, rn: Sequence[torch.Tensor], aspect: float) -> torch.Tensor:
        """The ray branch, at its native 2·l1 scale: aux chain → five 3x3
        convs → + UV field → conv → LayerNorm → relu → 1x1 logits."""
        a = self.aux(rn)
        for conv in self.aux_conv1:
            a = conv(a)
        a = a + _uv_table(a.shape[1], a.shape[2], self.fusion_channels // 2, aspect,
                          a.device, a.dtype)
        return self.aux_conv3(F.relu(self.aux_ln(self.aux_conv2(a))))

    def forward(self, feats: Sequence[torch.Tensor], H: int, W: int,
                outputs: Sequence[str] = ANYVIEW_OUTPUTS) -> Dict[str, torch.Tensor]:
        B, S, Np, C = feats[0].shape
        p = self.patch_size
        gh, gw = H // p, W // p
        aspect = W / H
        stages = self.reassemble([f.reshape(B * S, Np, C) for f in feats], gh, gw, aspect)
        rn = [conv(s) for conv, s in zip(self.conv, stages)]

        def unfold(t):
            return t.reshape(B, S, *t.shape[1:])

        # head_conv1 → bilinear upsample → + UV field → head convs
        fused = resize(self.head_conv1(self.main(rn)), (gh * p, gw * p), mode="bilinear",
                       align_corners=True)
        fused = fused + _uv_table(fused.shape[1], fused.shape[2], self.fusion_channels // 2,
                                  aspect, fused.device, fused.dtype)
        logits = self.head_conv3(F.relu(self.head_conv2(fused)))
        out = {"depth": unfold(torch.exp(logits[..., 0]))}
        if "depth_conf" in outputs:
            out["depth_conf"] = unfold(torch.exp(logits[..., -1]) + 1.0)
        if "ray" in outputs or "ray_conf" in outputs:
            aux_logits = self._aux(rn, aspect)
            out["ray"] = unfold(aux_logits[..., :-1])
            out["ray_conf"] = unfold(torch.exp(aux_logits[..., -1]) + 1.0)
        return out


class DA3DPT(nn.Module):
    """Single-branch DPT with the sky head (the mono and metric presets): no
    token norm and no UV field; head_conv1, then the bilinear upsample;
    depth is exp of its logit, sky the relu of its own."""

    def __init__(self, dim_in: int, neck_channels: Sequence[int], fusion_channels: int,
                 patch_size: int = 14) -> None:
        super().__init__()
        fc = fusion_channels
        self.patch_size = patch_size
        self.reassemble = _DA3Reassemble(dim_in, neck_channels, use_norm=False, pos_embed=False)
        self.conv = _neck_convs(neck_channels, fc)
        self.main = _FusionChain(fc)
        self.head_conv1 = Conv(fc, fc // 2, 3, padding=1)
        self.head_conv2 = Conv(fc // 2, HEAD_CHANNELS, 3, padding=1)
        self.head_conv3 = Conv(HEAD_CHANNELS, 1, 1)
        self.sky_conv2 = Conv(fc // 2, HEAD_CHANNELS, 3, padding=1)
        self.sky_conv3 = Conv(HEAD_CHANNELS, 1, 1)

    def forward(self, feats: Sequence[torch.Tensor], H: int, W: int,
                outputs: Sequence[str] = SINGLE_OUTPUTS) -> Dict[str, torch.Tensor]:
        B, S, Np, C = feats[0].shape
        p = self.patch_size
        gh, gw = H // p, W // p
        stages = self.reassemble([f.reshape(B * S, Np, C) for f in feats], gh, gw, W / H)
        rn = [conv(s) for conv, s in zip(self.conv, stages)]
        fused = resize(self.head_conv1(self.main(rn)), (gh * p, gw * p), mode="bilinear",
                       align_corners=True)
        logits = self.head_conv3(F.relu(self.head_conv2(fused)))
        out = {"depth": torch.exp(logits[..., 0]).reshape(B, S, gh * p, gw * p)}
        if "sky" in outputs:
            sky = self.sky_conv3(F.relu(self.sky_conv2(fused)))
            out["sky"] = F.relu(sky[..., 0]).reshape(B, S, gh * p, gw * p)
        return out


class DA3CameraDec(nn.Module):
    """Camera token [B, S, C] → pose encoding [B, S, 9]: t (3), quaternion
    (4, XYZW), field of view (2, relu)."""

    def __init__(self, dim_in: int) -> None:
        super().__init__()
        self.fc0 = nn.Linear(dim_in, dim_in)
        self.fc1 = nn.Linear(dim_in, dim_in)
        self.fc_t = nn.Linear(dim_in, 3)
        self.fc_qvec = nn.Linear(dim_in, 4)
        self.fc_fov = nn.Linear(dim_in, 2)

    def forward(self, cam_token: torch.Tensor) -> torch.Tensor:
        B, S, C = cam_token.shape
        h = F.relu(self.fc1(F.relu(self.fc0(cam_token.reshape(B * S, C)))))
        out = torch.cat([self.fc_t(h), self.fc_qvec(h), F.relu(self.fc_fov(h))], dim=-1)
        return out.reshape(B, S, 9)


# ---------------------------------------------------------------------------
# Whole nets
# ---------------------------------------------------------------------------

class DepthAnything3(nn.Module):
    """Trunk + head (+ the camera decoder for the anyview presets).
    `predict(pixels, outputs)` → dict of the outputs named (None: every
    output of the preset): depth [B, S, H, W], depth_conf, ray [B, S, h, w,
    6], ray_conf, pose_enc [B, S, 9] (anyview), or depth and sky (mono,
    metric).  `forward(pixels)` → the frame's depth [B, H, W]
    (`da3_depth_apply`).  `quant=True` makes the trunk's dense products int8
    (K4); the heads stay float."""

    def __init__(self, variant: str, mode: str = "anyview", hidden_size: int = 0,
                 num_layers: int = 0, num_heads: int = 0, mlp_dim: int = 0,
                 patch_size: int = 14, quant: bool = False) -> None:
        super().__init__()
        if mode not in ("anyview", "mono", "metric"):
            raise ValueError(f"unknown DA3 mode {mode!r}")
        self.mode, self.anyview = mode, mode == "anyview"
        out_layers, alt_start, neck, fusion = DA3_PRESETS[variant]
        if not self.anyview:
            out_layers, alt_start = DA3_MONO_OUT_LAYERS, -1
        self.backbone = DA3Backbone(
            hidden_size, num_layers, num_heads, mlp_dim, tuple(out_layers),
            alt_start=alt_start, patch_size=patch_size, use_swiglu=variant == "vitg",
            quant=quant)
        dim_in = hidden_size * (2 if self.anyview else 1)
        if self.anyview:
            self.head = DA3DualDPT(dim_in, neck, fusion, patch_size)
            self.cam_dec = DA3CameraDec(dim_in)
        else:
            self.head = DA3DPT(dim_in, neck, fusion, patch_size)
        self.output_keys = ANYVIEW_OUTPUTS if self.anyview else SINGLE_OUTPUTS

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "DepthAnything3":
        hidden, layers, heads, mlp = spec.dims
        return cls(variant=spec.variant, mode=da3_mode(spec.name), hidden_size=hidden,
                   num_layers=layers, num_heads=heads, mlp_dim=mlp,
                   patch_size=spec.patch_size, quant=quant)

    def predict(self, pixels: torch.Tensor,
                outputs: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
        keys = self.output_keys if outputs is None else tuple(outputs)
        unknown = set(keys) - set(self.output_keys)
        if unknown:
            raise ValueError(f"DA3 {self.mode} has no outputs {sorted(unknown)}; "
                             f"it has {self.output_keys}")
        if pixels.ndim == 4:
            pixels = pixels[:, None]  # one view
        H, W = pixels.shape[2], pixels.shape[3]
        feats, cam_tokens = self.backbone(pixels)
        out = self.head(list(feats), H, W, keys)
        if "pose_enc" in keys:
            out["pose_enc"] = self.cam_dec(cam_tokens[-1])
        return out

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return da3_depth_apply(self, pixels)


class DA3Nested(nn.Module):
    """DA3NESTED-GIANT-LARGE: an anyview branch (`da3`, the spec's variant)
    and a metric ViT-L branch (`da3_metric`); forward(pixels [B, H, W, 3]) →
    the anyview depth aligned onto the metric branch (`nested_align`)."""

    def __init__(self, variant: str, hidden_size: int, num_layers: int, num_heads: int,
                 mlp_dim: int, patch_size: int = 14) -> None:
        super().__init__()
        self.da3 = DepthAnything3(variant, "anyview", hidden_size, num_layers, num_heads,
                                  mlp_dim, patch_size)
        lh, ll, lhd, lm = VIT_VARIANTS["vitl"]
        self.da3_metric = DepthAnything3("vitl", "metric", lh, ll, lhd, lm, patch_size)

    @classmethod
    def from_spec(cls, spec: ModelSpec) -> "DA3Nested":
        hidden, layers, heads, mlp = spec.dims
        return cls(spec.variant, hidden, layers, heads, mlp, spec.patch_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        H, W = pixels.shape[-3], pixels.shape[-2]
        out = self.da3.predict(pixels, ("depth", "depth_conf", "pose_enc"))
        metric_out = self.da3_metric.predict(pixels, ("depth", "sky"))
        return nested_align(out, metric_out, (H, W))[:, 0]


def from_spec(spec: ModelSpec, quant: bool = False) -> nn.Module:
    """The DA3 registry model for `spec`: DA3Nested for the NESTED preset
    (always float: `build_bound` refuses int8 for it before any draw), else
    DepthAnything3 (anyview, mono or metric by name)."""
    if is_da3_nested(spec):
        return DA3Nested.from_spec(spec)
    return DepthAnything3.from_spec(spec, quant=quant)


# ---------------------------------------------------------------------------
# Post-processing
# ---------------------------------------------------------------------------

def _quantile_index(n_valid: torch.Tensor, q: float, n: int) -> torch.Tensor:
    """int(q·(n_valid − 1)) in f32, clipped to [0, n − 1] (JAX's arithmetic)."""
    return (q * (n_valid.float() - 1.0)).to(torch.int32).clamp(0, n - 1).long()


def _masked_quantile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Per batch element (axis 0), the q-quantile of the masked values by an
    inf-ranked sort; returns [B] (inf where the mask is empty)."""
    B = values.shape[0]
    flat, m = values.reshape(B, -1), mask.reshape(B, -1)
    ranked = torch.sort(torch.where(m, flat, torch.inf), dim=1).values
    idx = _quantile_index(m.sum(dim=1), q, flat.shape[1])
    return torch.gather(ranked, 1, idx[:, None])[:, 0]


def sky_to_max_depth(depth: torch.Tensor, sky: torch.Tensor) -> torch.Tensor:
    """The mono and metric presets' sky post: sky pixels take the
    SKY_QUANTILE of the non-sky depth, per batch element, unless either
    class has at most SKY_MIN_PIXELS pixels."""
    B = depth.shape[0]
    non_sky = sky < SKY_THRESHOLD
    n = depth[0].numel()
    n_valid = non_sky.reshape(B, -1).sum(dim=1)
    non_sky_max = _masked_quantile(depth, non_sky, SKY_QUANTILE)
    enough = (n_valid > SKY_MIN_PIXELS) & ((n - n_valid) > SKY_MIN_PIXELS)
    bshape = (B,) + (1,) * (depth.ndim - 1)
    filled = torch.where(non_sky, depth, non_sky_max.reshape(bshape))
    return torch.where(enough.reshape(bshape), filled, depth)


def da3_depth_apply(model: DepthAnything3, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] → depth [B, H, W]: the single view's depth, with
    the sky post where the preset has a sky head."""
    out = model.predict(pixels, ("depth",) if model.anyview else ("depth", "sky"))
    depth = out["depth"][:, 0]
    if "sky" in out:
        depth = sky_to_max_depth(depth, out["sky"][:, 0])
    return depth


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """XYZW quaternion [..., 4] → rotation matrix [..., 3, 3]."""
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.clamp_min((q * q).sum(dim=-1), 1e-12)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, image_hw: Tuple[int, int]):
    """(t, quat, fov) encoding [..., 9] → (extrinsics [..., 3, 4],
    intrinsics [..., 3, 3])."""
    T, quat = pose_enc[..., :3], pose_enc[..., 3:7]
    fov_h, fov_w = pose_enc[..., 7], pose_enc[..., 8]
    extr = torch.cat([quat_to_mat(quat), T[..., None]], dim=-1)
    H, W = image_hw
    fy = (H / 2.0) / torch.clamp_min(torch.tan(fov_h / 2.0), 1e-6)
    fx = (W / 2.0) / torch.clamp_min(torch.tan(fov_w / 2.0), 1e-6)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    intr = torch.stack([fx, zeros, ones * (W / 2.0),
                        zeros, fy, ones * (H / 2.0),
                        zeros, zeros, ones], dim=-1).reshape(pose_enc.shape[:-1] + (3, 3))
    return extr, intr


def nested_align(out: Dict[str, torch.Tensor], metric_out: Dict[str, torch.Tensor],
                 image_hw: Tuple[int, int]) -> torch.Tensor:
    """The NESTED alignment, per batch element: the metric depth scaled by
    the anyview camera's focal over 300; the anyview depth scaled onto it by
    least squares over confident (≥ the median confidence) non-sky pixels
    where both depths are positive; the sky set to the SKY_QUANTILE of the
    non-sky depth, capped at NESTED_SKY_DEPTH_CAP.  → [B, S, H, W]."""
    depth, conf = out["depth"], out["depth_conf"]
    sky, m_depth = metric_out["sky"], metric_out["depth"]
    _, intr = pose_encoding_to_extri_intri(out["pose_enc"], image_hw)
    focal = (intr[..., 0, 0] + intr[..., 1, 1]) / 2.0
    m_depth = m_depth * (focal[..., None, None] / 300.0)

    B = depth.shape[0]
    bshape = (B,) + (1,) * (depth.ndim - 1)
    non_sky = sky < SKY_THRESHOLD
    median_conf = _masked_quantile(conf, non_sky, 0.5).reshape(bshape)
    align = (conf >= median_conf) & non_sky & (m_depth > 1e-2) & (depth > 1e-3)
    a = torch.where(align, m_depth, 0.0).reshape(B, -1)
    b = torch.where(align, depth, 0.0).reshape(B, -1)
    scale = (a * b).sum(dim=1) / torch.clamp_min((b * b).sum(dim=1), 1e-12)
    depth = depth * scale.reshape(bshape)
    non_sky_max = torch.clamp_max(_masked_quantile(depth, non_sky, SKY_QUANTILE),
                                  NESTED_SKY_DEPTH_CAP)
    return torch.where(non_sky, depth, non_sky_max.reshape(bshape))
