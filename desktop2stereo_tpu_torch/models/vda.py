"""Video-Depth-Anything: DINOv2 + a temporal DPT head with a rolling window.

Port of `desktop2stereo_tpu/models/vda.py`.  The DINOv2 encoder (original
weights: position table interpolated with offset 0.1) feeds a DPT decoder
with four temporal modules: on the reassembled layer-3 and layer-4 features
and on the two coarsest fusion paths.  Each runs, per pixel, attention across
time over a window of 32 frames.  Streaming, the window is a carry of the
previous 31 frames' inputs to each of the 8 attention sites:

    first(pixels)        → (depth, carry)   frame 0's entries, replicated ×31
    step(pixels, carry)  → (depth, carry')  carry shifted left, entry appended

The carry is a tuple of 8 tensors [B, P, 31, C] (P the pixels of the site's
feature map): sites 0-1 temporal module 0 (the patch grid, C = neck[2]),
2-3 module 1 (half the grid, neck[3]), 4-5 module 2 (the grid, fusion
channels), 6-7 module 3 (twice the grid, fusion channels).  `clip` runs
clips of up to 32 frames, every frame attending to every other.

The time-axis attention is plain PyTorch, as it is plain XLA in the JAX
package (no Pallas kernel): thousands of sequences of one query and at most
32 keys, head dim C / 8.  Logits and softmax are f32, the probabilities are
cast to the input's dtype, q/k/v have no bias, and each step recomputes K
and V over the whole window, as the JAX module does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.models.dinov2 import LN_EPS, Dinov2Encoder
from desktop2stereo_tpu_torch.models.dpt import (
    HEAD_CHANNELS, REASSEMBLE_FACTORS, Conv, FeatureFusionLayer, ReassembleLayer)
from desktop2stereo_tpu_torch.ops.activations import gelu
from desktop2stereo_tpu_torch.ops.resize import resize

INFER_LEN = 32          # the temporal window, and the APE table's length
CACHE_LEN = INFER_LEN - 1
NUM_HEADS = 8
NUM_ATTN_BLOCKS = 2     # attention blocks per temporal module
NUM_SITES = 4 * NUM_ATTN_BLOCKS
GROUPS, GN_EPS = 32, 1e-6
POS_OFFSET = 0.1        # the original DINOv2's position-table interpolation offset

VDAState = Tuple[torch.Tensor, ...]  # the 8 caches [B, P, CACHE_LEN, C]


def _ape_table(d_model: int, max_len: int = INFER_LEN) -> np.ndarray:
    """Sin/cos absolute positional encoding, built in f64, returned f32."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _ape(d_model: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The APE table on `device` in `dtype`, uploaded once (outside inference
    mode, so that it also serves callers outside it)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_ape_table(d_model)).to(device, dtype)


class TemporalAttention(nn.Module):
    """Per-pixel attention across time.  x [R, f, C] (R = B·pixels, f the
    frames of this call); with `cache` [R, n, C] the keys and values span
    cache + x (n + f positions) and the queries only x; APE positions count
    from the window's start.  Returns (out [R, f, C], entry [R, f, C]), the
    entry being x before APE, which is what the window keeps."""

    def __init__(self, channels: int, heads: int = NUM_HEADS) -> None:
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(channels, channels, bias=False)
        self.to_k = nn.Linear(channels, channels, bias=False)
        self.to_v = nn.Linear(channels, channels, bias=False)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None):
        R, f, C = x.shape
        full = x if cache is None else torch.cat([cache, x], dim=1)
        n = full.shape[1]
        full = full + _ape(C, x.device, x.dtype)[:n]
        hd = C // self.heads
        q = self.to_q(full[:, n - f:]).reshape(R, f, self.heads, hd).transpose(1, 2)
        k = self.to_k(full).reshape(R, n, self.heads, hd).transpose(1, 2)
        v = self.to_v(full).reshape(R, n, self.heads, hd).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(R, f, C)
        return self.to_out(out), x


class TemporalTransformer(nn.Module):
    """One temporal module: GroupNorm (per frame, 32 groups) → proj_in →
    2 × (LayerNorm → TemporalAttention → residual) → GEGLU feed-forward →
    proj_out → residual.  x [B, T, H, W, C]; caches None or two [B, H·W, n, C].
    Returns (y, (entry0, entry1)), entries [B, H·W, T, C].

    `norm` is the GroupNorm and `norm_0`/`norm_1` the attention blocks'
    LayerNorms, as the JAX parameter tree names them."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        C = channels
        self.norm = nn.GroupNorm(GROUPS, C, eps=GN_EPS)
        self.proj_in = nn.Linear(C, C)
        self.attn = nn.ModuleList(TemporalAttention(C) for _ in range(NUM_ATTN_BLOCKS))
        self.norm_0 = nn.LayerNorm(C, eps=LN_EPS)
        self.norm_1 = nn.LayerNorm(C, eps=LN_EPS)
        self.ff_norm = nn.LayerNorm(C, eps=LN_EPS)
        self.ff_proj = nn.Linear(C, 8 * C)
        self.ff_out = nn.Linear(4 * C, C)
        self.proj_out = nn.Linear(C, C)

    def forward(self, x: torch.Tensor, caches: Optional[Sequence[torch.Tensor]] = None):
        B, T, H, W, C = x.shape
        # GroupNorm per frame: time folded into the batch, channels first
        h = self.norm(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2))
        h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, T, H, W, C))
        h = h.permute(0, 2, 3, 1, 4).reshape(B * H * W, T, C)  # a time sequence per pixel
        entries = []
        for i, (norm, attn) in enumerate(zip((self.norm_0, self.norm_1), self.attn)):
            cache = None if caches is None else caches[i].reshape(B * H * W, -1, C)
            out, entry = attn(norm(h), cache)
            h = h + out
            entries.append(entry.reshape(B, H * W, T, C))
        val, gate = self.ff_proj(self.ff_norm(h)).chunk(2, dim=-1)
        h = self.proj_out(h + self.ff_out(val * gelu(gate)))
        y = h.reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4) + x
        return y, tuple(entries)


class VDAHead(nn.Module):
    """The temporal DPT head.  grids: 4 token grids [B·T, gh, gw, D]; time is
    folded into the batch except inside the temporal modules."""

    def __init__(self, hidden_size: int, neck_channels: Sequence[int],
                 fusion_channels: int, patch_size: int = 14) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.reassemble = nn.ModuleList(
            ReassembleLayer(hidden_size, c, f) for c, f in zip(neck_channels, REASSEMBLE_FACTORS))
        self.conv = nn.ModuleList(
            Conv(c, fusion_channels, 3, padding=1, bias=False) for c in neck_channels)
        self.fusion = nn.ModuleList(
            FeatureFusionLayer(fusion_channels, with_residual=i > 0) for i in range(4))
        self.temporal = nn.ModuleList(
            TemporalTransformer(c) for c in (neck_channels[2], neck_channels[3],
                                             fusion_channels, fusion_channels))
        self.head_conv1 = Conv(fusion_channels, fusion_channels // 2, 3, padding=1)
        self.head_conv2 = Conv(fusion_channels // 2, HEAD_CHANNELS, 3, padding=1)
        self.head_conv3 = Conv(HEAD_CHANNELS, 1, 1)

    def forward(self, grids: Sequence[torch.Tensor], frames: int,
                caches: Optional[Sequence[torch.Tensor]] = None):
        def temporal(idx: int, x: torch.Tensor):
            BT, h, w, C = x.shape
            site = None if caches is None else caches[2 * idx: 2 * idx + 2]
            y, entries = self.temporal[idx](x.reshape(BT // frames, frames, h, w, C), site)
            return y.reshape(BT, h, w, C), entries

        layer1, layer2, layer3, layer4 = (re(g) for re, g in zip(self.reassemble, grids))
        layer3, e0 = temporal(0, layer3)
        layer4, e1 = temporal(1, layer4)
        l1rn, l2rn, l3rn, l4rn = (conv(f) for conv, f in
                                  zip(self.conv, (layer1, layer2, layer3, layer4)))
        path4, e2 = temporal(2, self.fusion[0](l4rn, None, tuple(l3rn.shape[1:3])))
        path3, e3 = temporal(3, self.fusion[1](path4, l3rn, tuple(l2rn.shape[1:3])))
        path2 = self.fusion[2](path3, l2rn, tuple(l1rn.shape[1:3]))
        path1 = self.fusion[3](path2, l1rn, (l1rn.shape[1] * 2, l1rn.shape[2] * 2))
        gh, gw = grids[0].shape[1], grids[0].shape[2]
        x = resize(self.head_conv1(path1), (gh * self.patch_size, gw * self.patch_size),
                   mode="bilinear", align_corners=True)
        x = F.relu(self.head_conv3(F.relu(self.head_conv2(x))))
        return x[..., 0], e0 + e1 + e2 + e3


def init_state_from_entries(entries: Sequence[torch.Tensor]) -> VDAState:
    """The first frame's carry: each entry [B, P, 1, C] replicated ×31."""
    return tuple(e.expand(-1, -1, CACHE_LEN, -1).contiguous() for e in entries)


def update_state(state: VDAState, entries: Sequence[torch.Tensor]) -> VDAState:
    """Shift each cache left by one frame and append this frame's entry."""
    return tuple(torch.cat([c[:, :, 1:], e], dim=2) for c, e in zip(state, entries))


class VideoDepthAnything(nn.Module):
    """Encoder + temporal head.  forward(pixels [B·T, H, W, 3], frames,
    caches) → (depth [B·T, H, W], entries).  `quant=True` builds the int8
    encoder (K4); the head stays float.  Each batch row carries its own
    caches ([B, P, 31, C]): a batch of streams keeps one window a stream."""

    carry_per_stream = True  # the frame program's batched `fresh` mask applies

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int,
                 mlp_dim: int, out_layers: Tuple[int, ...],
                 neck_channels: Tuple[int, ...], fusion_channels: int,
                 patch_size: int = 14, quant: bool = False) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.patch_size = patch_size
        self.backbone = Dinov2Encoder(hidden_size, num_layers, num_heads, mlp_dim, out_layers,
                                      patch_size=patch_size, quant=quant,
                                      interpolate_offset=POS_OFFSET)
        self.head = VDAHead(hidden_size, neck_channels, fusion_channels, patch_size)

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "VideoDepthAnything":
        hidden, layers, heads, mlp = spec.dims
        return cls(hidden_size=hidden, num_layers=layers, num_heads=heads, mlp_dim=mlp,
                   out_layers=spec.dpt_layers, neck_channels=spec.neck_channels,
                   fusion_channels=spec.fusion_channels, patch_size=spec.patch_size,
                   quant=quant)

    def forward(self, pixels: torch.Tensor, frames: int = 1,
                caches: Optional[Sequence[torch.Tensor]] = None):
        BT, H, W, _ = pixels.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        grids = [f[:, 1:].reshape(BT, gh, gw, self.hidden_size) for f in self.backbone(pixels)]
        depth, entries = self.head(grids, frames, caches)
        # back to the input size: bilinear, align_corners, then relu
        depth = resize(depth[..., None], (H, W), mode="bilinear", align_corners=True)[..., 0]
        return F.relu(depth), entries

    def clip(self, pixels: torch.Tensor) -> torch.Tensor:
        """Clip mode: pixels [T, H, W, 3], every frame attending to all T."""
        if pixels.shape[0] > INFER_LEN:
            raise ValueError(
                f"VDA batch mode takes clips of ≤{INFER_LEN} frames (the temporal window / "
                f"APE table length); got {pixels.shape[0]}. Use the streaming first/step "
                f"path for longer videos.")
        return self(pixels, pixels.shape[0], None)[0]

    def first(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, VDAState]:
        depth, entries = self(pixels, 1, None)
        return depth, init_state_from_entries(entries)

    def step(self, pixels: torch.Tensor, state: VDAState) -> Tuple[torch.Tensor, VDAState]:
        depth, entries = self(pixels, 1, state)
        return depth, update_state(state, entries)


class StreamingVDA:
    """A VDA with its carry held inside: `apply(pixels) → depth` runs
    `first` on the first call and after a shape change, `step` otherwise
    (for use outside the frame program, which carries the state itself)."""

    def __init__(self, model: VideoDepthAnything) -> None:
        self.model = model
        self._state: Optional[VDAState] = None
        self._shape: Optional[Tuple[int, ...]] = None

    def reset(self) -> None:
        self._state = None
        self._shape = None

    @torch.inference_mode()
    def apply(self, pixels: torch.Tensor) -> torch.Tensor:
        if self._state is None or tuple(pixels.shape) != self._shape:
            depth, self._state = self.model.first(pixels)
            self._shape = tuple(pixels.shape)
        else:
            depth, self._state = self.model.step(pixels, self._state)
        return depth
