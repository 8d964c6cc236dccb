"""Video-Depth-Anything (arXiv:2501.12375) in plain float32 PyTorch, as it
streams: one frame a call, each attention site carrying the window of the
previous 31 frames.

A stateful family (`STATEFUL`): `forward(pixels, carry=None)` takes
normalized NCHW pixels and the carry, and returns (raw depth [B, H, W],
entries), the entries being what this frame adds to each site's window;
`advance(carry, entries)` is the next carry.  `carry=None` is the first
call, whose window holds the frame alone.

- Trunk: the DINOv2 of `vit.py`, its position table sampled at scale
  (g + 0.1) / 37 (the original DINOv2's `interpolate_offset`, with which the
  published weights were trained), bicubic, align_corners False, in float32.
- Neck and fusion: the modules of `depth_anything.py` (`Reassemble`,
  `Fusion`), under the program's names (`head.reassemble`, `head.conv`,
  `head.fusion`).
- Four temporal modules, on the reassembled layer-3 and layer-4 maps and on
  the outputs of the two coarsest fusion stages: GroupNorm (32 groups, per
  frame), `proj_in`, 2 × (LayerNorm, 8-head attention across time per pixel
  with q, k and v unbiased, sin/cos APE added to the window from its start,
  logits and softmax in float32, residual), a GEGLU feed-forward (×4, exact
  GELU) as a residual, `proj_out`, and the module's residual.  The window
  keeps each block's input before APE: sites 2i and 2i+1 are module i's two
  attention blocks, each [B, P, 31, C] (P the pixels of its map).
- Head: a 3x3 convolution, a bilinear (align_corners True) resize to the
  patch grid's pixels, a 3x3 convolution, ReLU, a 1x1 convolution, ReLU, and
  a bilinear resize to the input's size with a last ReLU.

Departures from the published description: one frame a call (the clip
mode's T-frame windows are not on the streaming path); each step projects
K and V again over the whole window, as a plain attention does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereobench.reference import tables, vit
from stereobench.reference.depth_anything import (  # noqa: F401 (the family's protocol)
    RESIZE_FACTORS, Fusion, Reassemble, model_input_size)

STATEFUL = True
WINDOW = 32           # frames a temporal attention spans, and the APE table's length
CARRY = WINDOW - 1    # frames a site carries
HEADS = 8
BLOCKS = 2            # attention blocks a temporal module
FF_MULT = 4           # GEGLU's hidden width over the channels
GROUPS, EPS = 32, 1e-6
POS_OFFSET = 0.1

Carry = Tuple[torch.Tensor, ...]

_TEMPORAL_LOG: Optional[List[Tuple[int, int, int, int]]] = None


@contextlib.contextmanager
def record_temporal() -> Iterator[List[Tuple[int, int, int, int]]]:
    """Collect (B, P, n, C) of every temporal module call made inside: the
    batch, the pixels of its map, the window's frames with this one, and
    the channels."""
    global _TEMPORAL_LOG
    log: List[Tuple[int, int, int, int]] = []
    prev, _TEMPORAL_LOG = _TEMPORAL_LOG, log
    try:
        yield log
    finally:
        _TEMPORAL_LOG = prev


def advance(carry: Optional[Carry], entries: Sequence[torch.Tensor]) -> Carry:
    """The next carry: each site's window shifted left by one frame with the
    entry [B, P, 1, C] appended; on a first call (`carry` None) the entry
    replicated 31 times."""
    if carry is None:
        return tuple(e.expand(-1, -1, CARRY, -1) for e in entries)
    return tuple(torch.cat([c[:, :, 1:], e], dim=2) for c, e in zip(carry, entries))


def ape(n: int, channels: int, device, dtype) -> torch.Tensor:
    """The first n rows of the sin/cos table [WINDOW, channels], made in
    float64 and rounded to float32."""
    pos = torch.arange(WINDOW, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, channels, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / channels))
    table = torch.zeros(WINDOW, channels, dtype=torch.float64)
    table[:, 0::2] = torch.sin(pos * div)
    table[:, 1::2] = torch.cos(pos * div)
    return table[:n].float().to(device=device, dtype=dtype)


class OffsetEmbeddings(vit.Embeddings):
    """DINOv2's embeddings with the position table sampled at scale
    (g + 0.1) / grid, as the original code's scale_factor call does."""

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        B, _, H, W = pixels.shape
        gh, gw = H // self.patch, W // self.patch
        tokens = self.patch_embeddings(pixels)
        pos = self.position_embeddings
        M = self.grid
        grid = pos[:, 1:].reshape(1, M, M, self.hidden).permute(0, 3, 1, 2).float()
        grid = F.interpolate(grid, scale_factor=((gh + POS_OFFSET) / M, (gw + POS_OFFSET) / M),
                             mode="bicubic", align_corners=False)
        if grid.shape[-2:] != (gh, gw):
            raise ValueError(f"position table sampled to {tuple(grid.shape[-2:])}, "
                             f"want {(gh, gw)}")
        patch_pos = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, self.hidden).to(pos.dtype)
        cls = self.cls_token.expand(B, 1, self.hidden)
        return torch.cat([cls, tokens], dim=1) + torch.cat([pos[:, :1], patch_pos], dim=1)


class TemporalAttention(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(c, c, bias=False)
        self.to_v = nn.Linear(c, c, bias=False)
        self.to_out = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, window: Optional[torch.Tensor]) -> torch.Tensor:
        """x [R, 1, C] (R sequences, one per pixel), window [R, n-1, C] or
        None → [R, 1, C]: the query at the window's last position."""
        R, _, C = x.shape
        full = x if window is None else torch.cat([window, x], dim=1)
        n, d = full.shape[1], C // HEADS
        full = full + ape(n, C, x.device, x.dtype)
        q = self.to_q(full[:, -1:]).reshape(R, 1, HEADS, d).transpose(1, 2)
        k = self.to_k(full).reshape(R, n, HEADS, d).transpose(1, 2)
        v = self.to_v(full).reshape(R, n, HEADS, d).transpose(1, 2)
        logits = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
        out = logits.softmax(dim=-1).to(x.dtype) @ v
        return self.to_out(out.transpose(1, 2).reshape(R, 1, C))


class TemporalModule(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.norm = nn.GroupNorm(GROUPS, c, eps=EPS)
        self.proj_in = nn.Linear(c, c)
        self.attn = nn.ModuleList(TemporalAttention(c) for _ in range(BLOCKS))
        self.norm_0 = nn.LayerNorm(c, eps=EPS)
        self.norm_1 = nn.LayerNorm(c, eps=EPS)
        self.ff_norm = nn.LayerNorm(c, eps=EPS)
        self.ff_proj = nn.Linear(c, 2 * FF_MULT * c)
        self.ff_out = nn.Linear(FF_MULT * c, c)
        self.proj_out = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, windows: Optional[Sequence[torch.Tensor]]):
        """x NCHW [B, C, h, w], windows None or BLOCKS × [B, h·w, n-1, C] →
        (x with the module's output added, BLOCKS entries [B, h·w, 1, C])."""
        B, C, h, w = x.shape
        if _TEMPORAL_LOG is not None:
            _TEMPORAL_LOG.append((B, h * w, 1 if windows is None else windows[0].shape[2] + 1, C))
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))  # [B, P, C]
        t = t.reshape(B * h * w, 1, C)
        entries = []
        for i, (norm, attn) in enumerate(zip((self.norm_0, self.norm_1), self.attn)):
            e = norm(t)
            entries.append(e.reshape(B, h * w, 1, C))
            t = t + attn(e, None if windows is None else windows[i].reshape(B * h * w, -1, C))
        val, gate = self.ff_proj(self.ff_norm(t)).chunk(2, dim=-1)
        t = self.proj_out(t + self.ff_out(val * F.gelu(gate)))
        return x + t.reshape(B, h, w, C).permute(0, 3, 1, 2), entries


class Head(nn.Module):
    """The temporal DPT head under the program's names."""

    def __init__(self, hidden: int, channels: Sequence[int], fusion: int, head_hidden: int,
                 patch: int) -> None:
        super().__init__()
        self.patch = patch
        self.reassemble = nn.ModuleList(Reassemble(hidden, c, f)
                                        for c, f in zip(channels, RESIZE_FACTORS))
        self.conv = nn.ModuleList(nn.Conv2d(c, fusion, 3, padding=1, bias=False)
                                  for c in channels)
        self.fusion = nn.ModuleList(Fusion(fusion, i > 0) for i in range(len(channels)))
        self.temporal = nn.ModuleList(TemporalModule(c)
                                      for c in (channels[2], channels[3], fusion, fusion))
        self.head_conv1 = nn.Conv2d(fusion, fusion // 2, 3, padding=1)
        self.head_conv2 = nn.Conv2d(fusion // 2, head_hidden, 3, padding=1)
        self.head_conv3 = nn.Conv2d(head_hidden, 1, 1)

    def forward(self, maps: Sequence[torch.Tensor], carry: Optional[Carry]):
        entries: List[torch.Tensor] = []

        def temporal(i: int, x: torch.Tensor) -> torch.Tensor:
            y, e = self.temporal[i](x, None if carry is None else carry[2 * i:2 * i + 2])
            entries.extend(e)
            return y

        l1, l2, l3, l4 = (re(m) for re, m in zip(self.reassemble, maps))
        l3, l4 = temporal(0, l3), temporal(1, l4)
        r1, r2, r3, r4 = (conv(f) for conv, f in zip(self.conv, (l1, l2, l3, l4)))
        p4 = temporal(2, self.fusion[0](r4, None, tuple(r3.shape[-2:])))
        p3 = temporal(3, self.fusion[1](p4, r3, tuple(r2.shape[-2:])))
        p2 = self.fusion[2](p3, r2, tuple(r1.shape[-2:]))
        p1 = self.fusion[3](p2, r1, None)
        gh, gw = maps[0].shape[-2:]
        x = tables.interpolate(self.head_conv1(p1), (gh * self.patch, gw * self.patch),
                               align_corners=True)
        return F.relu(self.head_conv3(F.relu(self.head_conv2(x)))), tuple(entries)


class VideoDepthAnything(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        t = cfg["temporal"]
        stated = (t["window"], t["carry"], t["heads"], t["blocks_per_module"],
                  t["feed_forward_mult"], cfg["interpolate_offset"])
        if stated != (WINDOW, CARRY, HEADS, BLOCKS, FF_MULT, POS_OFFSET):
            raise ValueError(f"the configuration states window, carry, heads, blocks, "
                             f"GEGLU width and position offset {stated}; this reference "
                             f"computes {(WINDOW, CARRY, HEADS, BLOCKS, FF_MULT, POS_OFFSET)}")
        self.patch = cfg["patch_size"]
        self.backbone = vit.Dinov2(cfg["hidden_size"], cfg["num_hidden_layers"],
                                   cfg["num_attention_heads"], cfg["intermediate_size"],
                                   self.patch, cfg["out_indices"], cfg["pretrain_grid"],
                                   cfg["layer_norm_eps"])
        self.backbone.embeddings = OffsetEmbeddings(cfg["hidden_size"], self.patch,
                                                    cfg["pretrain_grid"])
        self.head = Head(cfg["hidden_size"], cfg["neck_hidden_sizes"], cfg["fusion_hidden_size"],
                         cfg["head_hidden_size"], self.patch)

    def forward(self, pixels: torch.Tensor, carry: Optional[Carry] = None):
        H, W = pixels.shape[-2:]
        gh, gw = H // self.patch, W // self.patch
        maps = [vit.tokens_to_map(t, gh, gw) for t in self.backbone(pixels)]
        depth, entries = self.head(maps, carry)
        if depth.shape[-2:] != (H, W):
            depth = tables.interpolate(depth, (H, W), align_corners=True)
        return F.relu(depth)[:, 0], entries


def build(cfg: dict) -> nn.Module:
    return VideoDepthAnything(cfg)


RESIZE_MODE = ("bicubic", True)  # the capture → model input resize: mode, antialias
