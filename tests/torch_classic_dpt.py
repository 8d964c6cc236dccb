"""Shared pieces of the classic DPT port tests (test_torch_dpt_vit.py,
test_torch_dpt_hybrid.py, test_torch_beit.py).

Synthetic checkpoints in the Hugging Face naming of DPTForDepthEstimation
(plain ViT, DINOv2, BEiT and BiT-hybrid backbones) at tiny widths, drawn
with numpy from a seed: each test converts one with the JAX converter and
with the port's, so both packages run the same weights.  Also the frame
program settings, a comparison helper and the JAX TPU-dispatch fixture of
`test_torch_pipeline.py` (re-exported for the test modules).
"""

import jax
import numpy as np
import torch

from test_torch_pipeline import (  # noqa: F401
    _assert_frames_match, _frames, jax_kernels)

NECK = (16, 32, 64, 64)
FUSION = 32
CFG = dict(depth_resolution=96, output_height=180, ipd=0.064, depth_strength=2.0,
           convergence=0.01, foreground_scale=0.0, aa_strength=2.0, ema_alpha=0.9,
           temporal_smooth=True, quality="high", emit_depth="model")
F32_TOL = 1e-5     # f32, port against JAX: max |port - JAX| / max |JAX|
INT8_TOL = 1e-2    # int8 models on one quantized tree (tests/test_torch_quant.py)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def assert_trees_equal(got, want) -> None:
    """Two nested dicts of arrays, leaf for leaf and exactly."""
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_array_equal(np.asarray(got_leaves[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


class Synth:
    """A seeded HF-named state dict under construction."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def arr(self, name, shape, std=0.02, mean=0.0):
        self.sd[name] = (mean + std * self.rng.standard_normal(shape)).astype(np.float32)

    def linear(self, prefix, fin, fout, bias=True):
        self.arr(prefix + ".weight", (fout, fin), std=fin ** -0.5)
        if bias:
            self.arr(prefix + ".bias", (fout,), std=0.05)

    def conv(self, prefix, cin, cout, k, bias=True):
        self.arr(prefix + ".weight", (cout, cin, k, k), std=(cin * k * k) ** -0.5)
        if bias:
            self.arr(prefix + ".bias", (cout,), std=0.05)

    def norm(self, prefix, c):
        self.arr(prefix + ".weight", (c,), std=0.1, mean=1.0)
        self.arr(prefix + ".bias", (c,), std=0.05)


def hf_vit_layer(s: Synth, lp: str, D: int, mlp: int) -> None:
    s.norm(lp + "layernorm_before", D)
    s.norm(lp + "layernorm_after", D)
    for n in ("query", "key", "value"):
        s.linear(lp + "attention.attention." + n, D, D)
    s.linear(lp + "attention.output.dense", D, D)
    s.linear(lp + "intermediate.dense", D, mlp)
    s.linear(lp + "output.dense", mlp, D)


def hf_fusion_and_head(s: Synth, fusion: int, head: bool = True) -> None:
    for j in range(4):
        fp = f"neck.fusion_stage.layers.{j}."
        s.conv(fp + "projection", fusion, fusion, 1)
        for r in (1, 2):
            for c in (1, 2):
                s.conv(fp + f"residual_layer{r}.convolution{c}", fusion, fusion, 3)
    if head:
        s.conv("head.head.0", fusion, fusion // 2, 3)
        s.conv("head.head.2", fusion // 2, 32, 3)
        s.conv("head.head.4", 32, 1, 1)
        s.sd["head.head.4.bias"] += 0.5  # most of the depth above the final ReLU


def hf_classic_decoder(s: Synth, D: int, neck=NECK, fusion=FUSION) -> None:
    """neck.* (readout-project reassemble, convs, fusion) and head.head.*"""
    for i, (c, f) in enumerate(zip(neck, (4, 2, 1, -2))):
        s.linear(f"neck.reassemble_stage.readout_projects.{i}.0", 2 * D, D)
        rp = f"neck.reassemble_stage.layers.{i}."
        s.conv(rp + "projection", D, c, 1)
        if f > 1:  # ConvTranspose2d weight (in, out, f, f)
            s.arr(rp + "resize.weight", (c, c, f, f), std=c ** -0.5)
            s.arr(rp + "resize.bias", (c,), std=0.05)
        elif f < 0:
            s.conv(rp + "resize", c, c, 3)
        s.conv(f"neck.convs.{i}", c, fusion, 3, bias=False)
    hf_fusion_and_head(s, fusion)


def hf_dpt_vit(seed: int, D=64, layers=4, mlp=128, grid=4, patch=16) -> dict:
    s = Synth(seed)
    ep = "dpt.embeddings."
    s.arr(ep + "cls_token", (1, 1, D))
    s.arr(ep + "position_embeddings", (1, grid * grid + 1, D), std=0.5)
    s.conv(ep + "patch_embeddings.projection", 3, D, patch)
    for i in range(layers):
        hf_vit_layer(s, f"dpt.encoder.layer.{i}.", D, mlp)
    hf_classic_decoder(s, D)
    return s.sd


def hf_dinov2_dpt(seed: int, D=64, layers=4, mlp=128, swiglu=False, patch=14) -> dict:
    s = Synth(seed)
    bp = "backbone."
    s.arr(bp + "embeddings.cls_token", (1, 1, D))
    s.arr(bp + "embeddings.position_embeddings", (1, 37 * 37 + 1, D), std=0.5)
    s.conv(bp + "embeddings.patch_embeddings.projection", 3, D, patch)
    for i in range(layers):
        lp = f"{bp}encoder.layer.{i}."
        s.norm(lp + "norm1", D)
        s.norm(lp + "norm2", D)
        for n in ("query", "key", "value"):
            s.linear(lp + "attention.attention." + n, D, D)
        s.linear(lp + "attention.output.dense", D, D)
        s.arr(lp + "layer_scale1.lambda1", (D,), std=0.1, mean=1.0)
        s.arr(lp + "layer_scale2.lambda1", (D,), std=0.1, mean=1.0)
        if swiglu:
            hidden = (int(mlp * 2 / 3) + 7) // 8 * 8
            s.linear(lp + "mlp.weights_in", D, 2 * hidden)
            s.linear(lp + "mlp.weights_out", hidden, D)
        else:
            s.linear(lp + "mlp.fc1", D, mlp)
            s.linear(lp + "mlp.fc2", mlp, D)
    s.norm(bp + "layernorm", D)
    hf_classic_decoder(s, D)
    return s.sd


def hf_beit_dpt(seed: int, D=64, layers=4, heads=4, mlp=128, window=4, patch=16) -> dict:
    s = Synth(seed)
    bp = "backbone."
    s.arr(bp + "embeddings.cls_token", (1, 1, D))
    s.conv(bp + "embeddings.patch_embeddings.projection", 3, D, patch)
    for i in range(layers):
        lp = f"{bp}encoder.layer.{i}."
        ap = lp + "attention.attention."
        s.norm(lp + "layernorm_before", D)
        s.norm(lp + "layernorm_after", D)
        s.linear(ap + "query", D, D)
        s.linear(ap + "key", D, D, bias=False)
        s.linear(ap + "value", D, D)
        s.arr(ap + "relative_position_bias.relative_position_bias_table",
              ((2 * window - 1) ** 2 + 3, heads), std=1.0)
        s.linear(lp + "attention.output.dense", D, D)
        s.linear(lp + "intermediate.dense", D, mlp)
        s.linear(lp + "output.dense", mlp, D)
        s.arr(lp + "lambda_1", (D,), std=0.1, mean=1.0)
        s.arr(lp + "lambda_2", (D,), std=0.1, mean=1.0)
    hf_classic_decoder(s, D)
    return s.sd


# the JAX DPT-Hybrid parity test's tiny configuration (tests/test_models_dpt_hybrid.py)
HYBRID = dict(patch_size=16, bit_depths=(1, 2, 1), bit_hidden=(16, 32, 64), bit_embed=8,
              bit_groups=4, vit_hidden=32, vit_layers=4, vit_heads=4, vit_mlp=64,
              vit_out=(2, 3), neck_channels=(16, 32, 32, 32), fusion=16, pretrain_grid=4)


def hf_dpt_hybrid(seed: int, cfg=HYBRID) -> dict:
    from desktop2stereo_tpu_torch.models.dpt_hybrid import _make_div

    s = Synth(seed)
    bp = "dpt.embeddings.backbone.bit."
    s.conv(bp + "embedder.convolution", 3, cfg["bit_embed"], 7, bias=False)
    s.norm(bp + "embedder.norm", cfg["bit_embed"])
    cin = cfg["bit_embed"]
    for st, (depth, hidden) in enumerate(zip(cfg["bit_depths"], cfg["bit_hidden"])):
        out = _make_div(hidden)
        mid = _make_div(int(out * 0.25))
        for l in range(depth):
            lp = f"{bp}encoder.stages.{st}.layers.{l}."
            if l == 0:
                s.conv(lp + "downsample.conv", cin, out, 1, bias=False)
                s.norm(lp + "downsample.norm", out)
            for ci, (a, b, k) in enumerate(((cin, mid, 1), (mid, mid, 3), (mid, out, 1)), 1):
                s.conv(lp + f"conv{ci}", a, b, k, bias=False)
                s.norm(lp + f"norm{ci}", b)
            cin = out
    D, G = cfg["vit_hidden"], cfg["pretrain_grid"]
    s.conv("dpt.embeddings.projection", cin, D, 1)
    s.arr("dpt.embeddings.cls_token", (1, 1, D))
    s.arr("dpt.embeddings.position_embeddings", (1, G * G + 1, D), std=0.5)
    for i in range(cfg["vit_layers"]):
        hf_vit_layer(s, f"dpt.encoder.layer.{i}.", D, cfg["vit_mlp"])
    neck, fusion = cfg["neck_channels"], cfg["fusion"]
    for si in (2, 3):
        s.linear(f"neck.reassemble_stage.readout_projects.{si}.0", 2 * D, D)
        rp = f"neck.reassemble_stage.layers.{si}."
        s.conv(rp + "projection", D, neck[si], 1)
        if si == 3:
            s.conv(rp + "resize", neck[si], neck[si], 3)
    stage_ch = (_make_div(cfg["bit_hidden"][0]), _make_div(cfg["bit_hidden"][1]),
                neck[2], neck[3])
    for i, c in enumerate(stage_ch):
        s.conv(f"neck.convs.{i}", c, fusion, 3, bias=False)
    hf_fusion_and_head(s, fusion)
    return s.sd


def perturb(params, seed):
    """Every leaf moved by seeded noise: kernels by half their spread, zero
    and unit leaves (biases, norms, LayerScale) by 0.05, the relative-position
    tables drawn from N(0, 1) so that the bias moves the attention."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        if "relative_position_bias_table" in jax.tree_util.keystr(path):
            return rng.standard_normal(a.shape).astype(np.float32)
        std = 0.5 * float(a.std()) if a.size > 1 and a.std() > 0 else 0.05
        return (a + std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, params)


def pixels(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, h, w, 3)).astype(np.float32)


def port_depth(model, x: np.ndarray, **kw) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(x), **kw).numpy()
