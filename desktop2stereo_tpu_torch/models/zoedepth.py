"""ZoeDepth: the BEiT trunk, the classic DPT decoder as its relative head,
and a metric-bins head (Intel/zoedepth-nyu, -kitti, -nyu-kitti).

Port of `desktop2stereo_tpu/models/zoedepth.py` (HF
ZoeDepthForDepthEstimation).  The trunk is `models/beit.py`'s BEiT-L/16 on
a 24x24 pretraining window, and the model is stateful as DPT-BEiT is:
`first(pixels)` builds the 24 layers' [H, R] relative-position tables once
per capture shape and `step(pixels, tables)` carries them, where the JAX
package carries the dense biases (`make_zoe_stream_fns`).  The decoder's
head gives the relative depth; its fusion pyramid, its coarsest stage
("bottleneck") and the head's 32-wide mid features feed the metric head:

- a seed bin regressor (softplus bin centres) and four attractor layers
  over the fusion pyramid, the bins moved by the inverse attractor with its
  default alpha 300 and gamma 2 (HF's call passes no config values);
- a conditional log-binomial softmax over the bins, conditioned on the
  relative head's features;
- nyu-kitti carries two bin configurations and a `PatchTransformer` domain
  classifier (128 wide, 4 heads of 32, post-norm, a zero cls slot at the
  front, 1-D sin/cos positions).  Both branches run and `torch.where`
  keeps the voted one on the device, with no host sync.  Each of its
  attractor layers has 16 attractors, HF's quirk.

The metric head runs in float32 under a bf16 trunk (`F32Module`), as the
JAX module promotes it.  The `PatchTransformer`'s attention (head dim 32)
is plain matmuls and a softmax, as in JAX, outside the attention kernel.
NHWC throughout; module and parameter names follow the JAX tree.
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
from desktop2stereo_tpu_torch.core.runtime import F32Module
from desktop2stereo_tpu_torch.models.beit import DPTBEiT
from desktop2stereo_tpu_torch.models.dpt import HEAD_CHANNELS, Conv
from desktop2stereo_tpu_torch.ops.activations import gelu
from desktop2stereo_tpu_torch.ops.resize import resize

# name → (bin configurations (name, n_bins, min depth, max depth), multi-head)
ZOE_PRESETS = {
    "zoedepth-nyu": ([("nyu", 64, 1e-3, 10.0)], False),
    "zoedepth-kitti": ([("kitti", 64, 1e-3, 80.0)], False),
    "zoedepth-nyu-kitti": ([("nyu", 64, 1e-3, 10.0), ("kitti", 64, 1e-3, 80.0)], True),
}
N_ATTRACTORS = (16, 8, 4, 1)
BIN_EMBEDDING_DIM = 128
MAX_TEMP, MIN_TEMP = 50.0, 0.0212
ATTRACTOR_ALPHA = 300.0  # the inverse attractor's default alpha (gamma 2)
# the domain classifier's patch transformer: width, heads, MLP width, layers
PT_HIDDEN, PT_HEADS, PT_MLP, PT_LAYERS = 128, 4, 1024, 4


def _inv_attractor(dx: torch.Tensor) -> torch.Tensor:
    return dx / (1.0 + ATTRACTOR_ALPHA * dx ** 2)


def _resize_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear, align_corners=True, to `ref`'s H×W (a no-op at that size)."""
    if x.shape[1:3] == ref.shape[1:3]:
        return x
    return resize(x, (ref.shape[1], ref.shape[2]), mode="bilinear", align_corners=True)


class Projector(nn.Module):
    """1x1 conv → ReLU → 1x1 conv (also the seed bin regressor's body)."""

    def __init__(self, in_channels: int, out_channels: int, mlp_dim: int,
                 softplus: bool = False) -> None:
        super().__init__()
        self.softplus = softplus
        self.conv1 = Conv(in_channels, mlp_dim, 1)
        self.conv2 = Conv(mlp_dim, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(x)))
        return F.softplus(y) if self.softplus else y


def SeedBinRegressor(in_channels: int, n_bins: int, mlp_dim: int) -> Projector:
    """The softplus bin-centres regressor of the released checkpoints."""
    return Projector(in_channels, n_bins, mlp_dim, softplus=True)


class AttractorUnnormed(nn.Module):
    def __init__(self, n_attractors: int) -> None:
        super().__init__()
        self.conv1 = Conv(BIN_EMBEDDING_DIM, BIN_EMBEDDING_DIM, 1)
        self.conv2 = Conv(BIN_EMBEDDING_DIM, n_attractors, 1)

    def forward(self, x: torch.Tensor, prev_bin: torch.Tensor,
                prev_emb: torch.Tensor) -> torch.Tensor:
        x = x + _resize_to(prev_emb, x)
        attractors = F.softplus(self.conv2(F.relu(self.conv1(x))))
        bc = _resize_to(prev_bin, x)
        # the bins move by the mean inverse attractor over the attractors
        dx = attractors[..., :, None] - bc[..., None, :]
        return bc + _inv_attractor(dx).mean(dim=-2)


class ConditionalLogBinomial(nn.Module):
    """Per-pixel (p, t) MLP, then a log-binomial softmax over n_bins."""

    def __init__(self, n_bins: int, in_features: int, bottleneck_factor: int = 2) -> None:
        super().__init__()
        self.n_bins = n_bins
        mid = (in_features + BIN_EMBEDDING_DIM) // bottleneck_factor
        self.mlp_conv1 = Conv(in_features + BIN_EMBEDDING_DIM, mid, 1)
        self.mlp_conv2 = Conv(mid, 4, 1)

    def forward(self, main: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = F.softplus(self.mlp_conv2(gelu(self.mlp_conv1(torch.cat([main, cond], dim=-1)))))
        p = h[..., :2] + 1e-4
        t = h[..., 2:] + 1e-4
        prob = p[..., 0] / (p[..., 0] + p[..., 1])
        temp = (MAX_TEMP - MIN_TEMP) * (t[..., 0] / (t[..., 0] + t[..., 1])) + MIN_TEMP
        prob = prob.clamp(1e-4, 1.0)[..., None]
        one_minus = (1.0 - prob).clamp(1e-4, 1.0)
        k = torch.arange(self.n_bins, dtype=h.dtype, device=h.device)
        n1 = float(self.n_bins - 1)

        def log_binom(n, kk, e=1e-7):
            n, kk = n + e, kk + e
            return n * torch.log(n) - kk * torch.log(kk) - (n - kk) * torch.log(n - kk + e)

        y = (log_binom(torch.tensor(n1, dtype=h.dtype, device=h.device), k)
             + k * torch.log(prob) + (n1 - k) * torch.log(one_minus))
        return torch.softmax(y / temp[..., None], dim=-1)


def _binned_depth(probs: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    return (probs * _resize_to(centres, probs)).sum(dim=-1)


class MetricBinsHead(F32Module):
    """One bin configuration (HF ZoeDepthMetricDepthEstimationHead)."""

    def __init__(self, n_bins: int, channels: int) -> None:
        super().__init__()
        self.conv2 = Conv(channels, channels, 1)
        self.seed_bin_regressor = SeedBinRegressor(channels, n_bins, 256)
        self.seed_projector = Projector(channels, BIN_EMBEDDING_DIM, BIN_EMBEDDING_DIM)
        self.projector = nn.ModuleList(
            Projector(channels, BIN_EMBEDDING_DIM, BIN_EMBEDDING_DIM) for _ in N_ATTRACTORS)
        self.attractor = nn.ModuleList(AttractorUnnormed(n) for n in N_ATTRACTORS)
        self.conditional_log_binomial = ConditionalLogBinomial(n_bins, HEAD_CHANNELS + 1)

    def forward(self, features, bottleneck, fusion_blocks, relative_depth):
        x = self.conv2(bottleneck)
        prev_bin = self.seed_bin_regressor(x)
        prev_emb = self.seed_projector(x)
        for feat, proj, attractor in zip(fusion_blocks, self.projector, self.attractor):
            emb = proj(feat)
            prev_bin = attractor(emb, prev_bin, prev_emb)
            prev_emb = emb
        last = torch.cat([features, _resize_to(relative_depth[..., None], features)], dim=-1)
        probs = self.conditional_log_binomial(last, _resize_to(emb, last))
        return _binned_depth(probs, prev_bin)


@functools.lru_cache(maxsize=8)
def _positions(n: int, hidden: int, device: torch.device) -> torch.Tensor:
    """The 1-D sin/cos table [n, hidden] on `device`, built once per length
    (outside inference mode, so that it serves callers in or out of it)."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    idx = np.arange(0, hidden, 2, dtype=np.float64)[None, :]
    ang = pos * np.exp(idx * (-math.log(10000.0) / hidden))
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    with torch.inference_mode(False):
        return torch.from_numpy(pe).to(device)


class PatchTransformer(nn.Module):
    """The domain classifier's trunk (HF ZoeDepthPatchTransformerEncoder):
    1x1 conv embedding, a zero cls slot at the front, 1-D sin/cos, four
    post-norm encoder layers; returns the cls slot [B, hidden]."""

    def __init__(self, in_channels: int) -> None:
        super().__init__()
        D = PT_HIDDEN
        self.embedding = Conv(in_channels, D, 1)
        for name, fin, fout in (("q", D, D), ("k", D, D), ("v", D, D), ("out", D, D),
                                ("fc1", D, PT_MLP), ("fc2", PT_MLP, D)):
            setattr(self, name, nn.ModuleList(nn.Linear(fin, fout) for _ in range(PT_LAYERS)))
        self.norm1 = nn.ModuleList(nn.LayerNorm(D, eps=1e-5) for _ in range(PT_LAYERS))
        self.norm2 = nn.ModuleList(nn.LayerNorm(D, eps=1e-5) for _ in range(PT_LAYERS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        D, nh = PT_HIDDEN, PT_HEADS
        seq = self.embedding(x).reshape(B, H * W, D)
        seq = torch.cat([seq.new_zeros(B, 1, D), seq], dim=1)
        N = seq.shape[1]
        seq = seq + _positions(N, D, x.device).to(seq.dtype)[None]
        for q, k, v, out, fc1, fc2, n1, n2 in zip(self.q, self.k, self.v, self.out, self.fc1,
                                                   self.fc2, self.norm1, self.norm2):
            qh, kh, vh = (f(seq).reshape(B, N, nh, D // nh).transpose(1, 2) for f in (q, k, v))
            logits = qh @ kh.transpose(-1, -2) / math.sqrt(D // nh)
            attn = (torch.softmax(logits, dim=-1) @ vh).transpose(1, 2).reshape(B, N, D)
            seq = n1(seq + out(attn))
            seq = n2(seq + fc2(F.relu(fc1(seq))))
        return seq[:, 0]


class MultiMetricBinsHead(F32Module):
    """Two bin configurations routed by a domain vote (HF
    ZoeDepthMultipleMetricDepthEstimationHeads): both branches run, the
    vote picks one on the device."""

    def __init__(self, configs: Sequence[Tuple[str, int, float, float]], channels: int) -> None:
        super().__init__()
        self.names = tuple(c[0] for c in configs)
        half = BIN_EMBEDDING_DIM // 2
        self.conv2 = Conv(channels, channels, 1)
        self.patch_transformer = PatchTransformer(channels)
        self.classifier_fc1 = nn.Linear(PT_HIDDEN, 128)
        self.classifier_fc2 = nn.Linear(128, 2)
        self.seed_projector = Projector(channels, BIN_EMBEDDING_DIM, half)
        self.projector = nn.ModuleList(
            Projector(channels, BIN_EMBEDDING_DIM, half) for _ in N_ATTRACTORS)
        for name, n_bins, _, _ in configs:
            setattr(self, f"seed_bin_regressor_{name}", SeedBinRegressor(channels, n_bins, half))
            # HF passes n_attractors[i] as n_bins and keeps 16 attractors in every layer
            setattr(self, f"attractor_{name}",
                    nn.ModuleList(AttractorUnnormed(16) for _ in N_ATTRACTORS))
            setattr(self, f"conditional_log_binomial_{name}",
                    ConditionalLogBinomial(n_bins, HEAD_CHANNELS, bottleneck_factor=4))

    def forward(self, features, bottleneck, fusion_blocks, relative_depth):
        x = self.conv2(bottleneck)
        cls_emb = self.patch_transformer(x)
        logits = self.classifier_fc2(F.relu(self.classifier_fc1(cls_emb)))
        pick = torch.argmax(torch.softmax(logits.sum(dim=0), dim=-1))
        seed_emb = self.seed_projector(x)
        embs = [proj(feat) for proj, feat in zip(self.projector, fusion_blocks)]
        outs = []
        for name in self.names:
            prev_bin = getattr(self, f"seed_bin_regressor_{name}")(x)
            prev_emb = seed_emb
            for emb, attractor in zip(embs, getattr(self, f"attractor_{name}")):
                prev_bin = attractor(emb, prev_bin, prev_emb)
                prev_emb = emb
            probs = getattr(self, f"conditional_log_binomial_{name}")(
                features, _resize_to(embs[-1], features))
            outs.append(_binned_depth(probs, prev_bin))
        return torch.where(pick == 0, outs[0], outs[1])


class ZoeDepth(DPTBEiT):
    """pixels [B,H,W,3] (normalized 0.5/0.5) → metric depth [B,h',w'] at the
    relative head's resolution; `first` / `step` as DPTBEiT's.  `quant=True`
    makes the trunk's six products a layer int8 (K4); the heads stay float."""

    def __init__(self, preset: str, neck_channels: Sequence[int], fusion_channels: int,
                 patch_size: int = 16, quant: bool = False) -> None:
        super().__init__("zoedepth", neck_channels, fusion_channels, patch_size, quant)
        configs, multi = ZOE_PRESETS[preset]
        self.metric_head = (MultiMetricBinsHead(configs, fusion_channels) if multi
                            else MetricBinsHead(configs[0][1], fusion_channels))

    @classmethod
    def from_spec(cls, spec: ModelSpec, quant: bool = False) -> "ZoeDepth":
        return cls(spec.name, spec.neck_channels, spec.fusion_channels,
                   patch_size=spec.patch_size, quant=quant)

    def forward(self, pixels: torch.Tensor,
                tables: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        feats, gh, gw = self.backbone(pixels, tables)
        relative, aux = self.decoder(feats, gh, gw, return_aux=True)
        return self.metric_head(aux["features"].float(), aux["bottleneck"].float(),
                                [f.float() for f in aux["fusion"]], relative.float())
