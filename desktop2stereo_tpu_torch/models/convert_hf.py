"""HF / original checkpoint names → the JAX package's parameter tree, in numpy.

A copy of the numpy-only converters of `desktop2stereo_tpu/models/
convert_hf.py` (the port imports nothing of that package): each returns the
same nested tree of float32 arrays as its original, and `models/from_flax.py`
turns that tree into the port's state_dict.  A checkpoint therefore reaches
the port as it reaches the JAX package, through the same names:

    safetensors on disk → convert_* → from_flax → load_state_dict

Torch → flax layouts: Linear (out, in) → kernel (in, out); Conv2d
(out, in, kh, kw) → kernel (kh, kw, in, out); ConvTranspose2d (in, out, f, f)
kept; the patch conv (D, 3, p, p) → (p·p·3, D); HF's q/k/v Linears → one
fused qkv kernel (D, 3D).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

from desktop2stereo_tpu_torch.core.registry import ModelSpec, da3_mode
from desktop2stereo_tpu_torch.models.safetensors_io import load_checkpoint

Params = Dict[str, Any]


def _linear(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {"kernel": np.ascontiguousarray(sd[prefix + ".weight"].T),
            "bias": sd[prefix + ".bias"]}


def _conv(sd: Mapping[str, np.ndarray], prefix: str, bias: bool = True) -> Params:
    out: Params = {"kernel": np.ascontiguousarray(sd[prefix + ".weight"].transpose(2, 3, 1, 0))}
    if bias:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _layernorm(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def to_numpy_state_dict(obj: Any) -> Dict[str, np.ndarray]:
    """A checkpoint path (single file, index json or one shard; see
    `safetensors_io.load_checkpoint`) or a {name: tensor or array} mapping →
    {name: float32 array}."""
    if isinstance(obj, (str, os.PathLike)):
        obj = load_checkpoint(obj)
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def convert_dinov2_backbone(sd: Mapping[str, np.ndarray], num_layers: int,
                            use_swiglu: bool = False, prefix: str = "backbone.") -> Params:
    """HF Dinov2Backbone state dict slice → Dinov2Encoder params."""
    D = sd[prefix + "embeddings.cls_token"].shape[-1]
    pw = sd[prefix + "embeddings.patch_embeddings.projection.weight"]  # (D,3,p,p)
    params: Params = {
        "embeddings": {
            "cls_token": sd[prefix + "embeddings.cls_token"],
            "position_embeddings": sd[prefix + "embeddings.position_embeddings"],
            "patch_embeddings": {
                "kernel": np.ascontiguousarray(pw.transpose(2, 3, 1, 0).reshape(-1, D)),
                "bias": sd[prefix + "embeddings.patch_embeddings.projection.bias"],
            },
        },
        "layernorm": _layernorm(sd, prefix + "layernorm"),
    }
    for i in range(num_layers):
        lp = f"{prefix}encoder.layer.{i}."
        if lp + "norm1.weight" not in sd:
            break  # a converted encoder may be truncated to max(out_layers)
        att = lp + "attention.attention."
        qkv_kernel = np.ascontiguousarray(np.concatenate(
            [sd[att + n + ".weight"] for n in ("query", "key", "value")], axis=0).T)
        qkv_bias = np.concatenate([sd[att + n + ".bias"] for n in ("query", "key", "value")])
        if use_swiglu:
            mlp = {"weights_in": _linear(sd, lp + "mlp.weights_in"),
                   "weights_out": _linear(sd, lp + "mlp.weights_out")}
        else:
            mlp = {"fc1": _linear(sd, lp + "mlp.fc1"), "fc2": _linear(sd, lp + "mlp.fc2")}
        params[f"layer_{i}"] = {
            "norm1": _layernorm(sd, lp + "norm1"),
            "norm2": _layernorm(sd, lp + "norm2"),
            "attention": {"qkv": {"kernel": qkv_kernel, "bias": qkv_bias},
                          "proj": _linear(sd, lp + "attention.output.dense")},
            "layer_scale1": sd[lp + "layer_scale1.lambda1"],
            "layer_scale2": sd[lp + "layer_scale2.lambda1"],
            "mlp": mlp,
        }
    return params


def _convert_fusion_stage(sd: Mapping[str, np.ndarray], prefix: str = "neck.") -> Params:
    """HF DPT fusion_stage → fusion_{0..3}."""
    params: Params = {}
    for j in range(4):
        fp = f"{prefix}fusion_stage.layers.{j}."
        layer = {"projection": _conv(sd, fp + "projection"),
                 "res2": {"conv1": _conv(sd, fp + "residual_layer2.convolution1"),
                          "conv2": _conv(sd, fp + "residual_layer2.convolution2")}}
        if j > 0:
            # fusion layer 0 never receives a residual, so its
            # residual_layer1 weights are dead in the torch graph too
            layer["res1"] = {"conv1": _conv(sd, fp + "residual_layer1.convolution1"),
                             "conv2": _conv(sd, fp + "residual_layer1.convolution2")}
        params[f"fusion_{j}"] = layer
    return params


def convert_dpt_neck(sd: Mapping[str, np.ndarray], prefix: str = "neck.") -> Params:
    """HF DPT neck → reassemble_{0..3}, conv_{0..3} and fusion_{0..3}."""
    params = _convert_fusion_stage(sd, prefix)
    for i in range(4):
        rp = f"{prefix}reassemble_stage.layers.{i}."
        layer: Params = {"projection": _conv(sd, rp + "projection")}
        if rp + "resize.weight" in sd:
            if i == 3:  # stage 3 downsamples with a stride-2 Conv2d (out,in,3,3)
                layer["resize"] = _conv(sd, rp + "resize")
            else:       # ConvTranspose2d (in,out,f,f) kept as it is
                layer["resize"] = {"kernel": sd[rp + "resize.weight"],
                                   "bias": sd[rp + "resize.bias"]}
        params[f"reassemble_{i}"] = layer
        params[f"conv_{i}"] = _conv(sd, f"{prefix}convs.{i}", bias=False)
    return params


def convert_dpt_head(sd: Mapping[str, np.ndarray], prefix: str = "head.") -> Params:
    return {f"conv{i}": _conv(sd, f"{prefix}conv{i}") for i in (1, 2, 3)}


def convert_depth_anything(state_dict: Any, spec: ModelSpec) -> Params:
    """A whole HF DepthAnythingForDepthEstimation checkpoint → param tree."""
    sd = to_numpy_state_dict(state_dict)
    _, num_layers, _, _ = spec.dims
    return {"backbone": convert_dinov2_backbone(sd, num_layers,
                                                use_swiglu=(spec.variant == "vitg")),
            "neck": convert_dpt_neck(sd),
            "head": convert_dpt_head(sd)}


def convert_dinov2_original(sd: Mapping[str, np.ndarray], num_layers: int,
                            prefix: str = "pretrained.") -> Params:
    """Original (non-HF) DINOv2 naming → Dinov2Encoder params: the naming of
    the VDA checkpoints (blocks.{i}.attn.qkv already fused, ls1/ls2.gamma,
    the final `norm`)."""
    D = sd[prefix + "cls_token"].shape[-1]
    pw = sd[prefix + "patch_embed.proj.weight"]  # (D,3,p,p)
    params: Params = {
        "embeddings": {
            "cls_token": sd[prefix + "cls_token"],
            "position_embeddings": sd[prefix + "pos_embed"],
            "patch_embeddings": {
                "kernel": np.ascontiguousarray(pw.transpose(2, 3, 1, 0).reshape(-1, D)),
                "bias": sd[prefix + "patch_embed.proj.bias"],
            },
        },
        "layernorm": _layernorm(sd, prefix + "norm"),
    }
    for i in range(num_layers):
        lp = f"{prefix}blocks.{i}."
        if lp + "norm1.weight" not in sd:
            break
        params[f"layer_{i}"] = {
            "norm1": _layernorm(sd, lp + "norm1"),
            "norm2": _layernorm(sd, lp + "norm2"),
            "attention": {"qkv": _linear(sd, lp + "attn.qkv"),
                          "proj": _linear(sd, lp + "attn.proj")},
            "layer_scale1": sd[lp + "ls1.gamma"],
            "layer_scale2": sd[lp + "ls2.gamma"],
            "mlp": {"fc1": _linear(sd, lp + "mlp.fc1"), "fc2": _linear(sd, lp + "mlp.fc2")},
        }
    return params


def _convert_temporal_module(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    """head.motion_modules.{m}.temporal_transformer.* → TemporalTransformer
    params."""
    tt = prefix + "temporal_transformer."
    params: Params = {"norm": _layernorm(sd, tt + "norm"),  # GroupNorm weight/bias
                      "proj_in": _linear(sd, tt + "proj_in"),
                      "proj_out": _linear(sd, tt + "proj_out")}
    bp = tt + "transformer_blocks.0."
    for a in range(2):
        ap = f"{bp}attention_blocks.{a}."
        params[f"attn_{a}"] = {
            **{n: {"kernel": np.ascontiguousarray(sd[f"{ap}{n}.weight"].T)}
               for n in ("to_q", "to_k", "to_v")},
            "to_out": _linear(sd, ap + "to_out.0"),
        }
        params[f"norm_{a}"] = _layernorm(sd, f"{bp}norms.{a}")
    params["ff_norm"] = _layernorm(sd, bp + "ff_norm")
    params["ff_proj"] = _linear(sd, bp + "ff.net.0.proj")
    params["ff_out"] = _linear(sd, bp + "ff.net.2")
    return params


def convert_vda(state_dict: Any, spec: ModelSpec) -> Params:
    """Video-Depth-Anything checkpoint (original naming: pretrained.* +
    head.*) → VideoDepthAnything param tree."""
    sd = to_numpy_state_dict(state_dict)
    # some releases nest everything under "model."
    if not any(k.startswith("pretrained.") for k in sd) and any(
            k.startswith("model.pretrained.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    _, num_layers, _, _ = spec.dims

    head: Params = {}
    for i in range(4):
        layer: Params = {"projection": _conv(sd, f"head.projects.{i}")}
        if i != 2:
            rp = f"head.resize_layers.{i}"
            if i == 3:
                layer["resize"] = _conv(sd, rp)
            else:  # ConvTranspose2d (in,out,f,f) as it is
                layer["resize"] = {"kernel": sd[rp + ".weight"], "bias": sd[rp + ".bias"]}
        head[f"reassemble_{i}"] = layer
        head[f"conv_{i}"] = _conv(sd, f"head.scratch.layer{i + 1}_rn", bias=False)

    # fusion_{0..3} ↔ refinenet{4..1} (coarsest first, like the HF neck)
    for j, rn in enumerate((4, 3, 2, 1)):
        fp = f"head.scratch.refinenet{rn}."
        layer = {"projection": _conv(sd, fp + "out_conv"),
                 "res2": {"conv1": _conv(sd, fp + "resConfUnit2.conv1"),
                          "conv2": _conv(sd, fp + "resConfUnit2.conv2")}}
        if j > 0:  # refinenet4 never receives a residual; its unit1 is dead
            layer["res1"] = {"conv1": _conv(sd, fp + "resConfUnit1.conv1"),
                             "conv2": _conv(sd, fp + "resConfUnit1.conv2")}
        head[f"fusion_{j}"] = layer

    for m in range(4):
        head[f"temporal_{m}"] = _convert_temporal_module(sd, f"head.motion_modules.{m}.")

    head["head_conv1"] = _conv(sd, "head.scratch.output_conv1")
    head["head_conv2"] = _conv(sd, "head.scratch.output_conv2.0")
    head["head_conv3"] = _conv(sd, "head.scratch.output_conv2.2")
    return {"backbone": convert_dinov2_original(sd, num_layers), "head": head}


def _convert_da3_backbone(sd: Mapping[str, np.ndarray], spec: ModelSpec,
                          anyview: bool, prefix: str) -> Params:
    """DA3's DinoVisionTransformer naming (blocks.{i}.attn.{qkv,proj,q_norm,
    k_norm}, ls1/ls2.gamma, mlp.{fc1,fc2} or ViT-G's SwiGLU mlp.{w12,w3}) →
    DA3Backbone params."""
    hidden, num_layers, _, _ = spec.dims
    pw = sd[prefix + "patch_embed.proj.weight"]  # (D,3,p,p)
    params: Params = {
        "cls_token": sd[prefix + "cls_token"],
        "pos_embed": sd[prefix + "pos_embed"],
        "patch_kernel": np.ascontiguousarray(pw.transpose(2, 3, 1, 0).reshape(-1, hidden)),
        "patch_bias": sd[prefix + "patch_embed.proj.bias"],
        "norm": _layernorm(sd, prefix + "norm"),
    }
    if anyview:
        params["camera_token"] = sd[prefix + "camera_token"]
    for i in range(num_layers):
        lp = f"{prefix}blocks.{i}."
        attn: Params = {"qkv": _linear(sd, lp + "attn.qkv"),
                        "proj": _linear(sd, lp + "attn.proj")}
        if lp + "attn.q_norm.weight" in sd:  # the QK-norm blocks only
            attn["q_norm"] = _layernorm(sd, lp + "attn.q_norm")
            attn["k_norm"] = _layernorm(sd, lp + "attn.k_norm")
        if lp + "mlp.w12.weight" in sd:      # ViT-G SwiGLU
            mlp = {"w12": _linear(sd, lp + "mlp.w12"), "w3": _linear(sd, lp + "mlp.w3")}
        else:
            mlp = {"fc1": _linear(sd, lp + "mlp.fc1"), "fc2": _linear(sd, lp + "mlp.fc2")}
        params[f"layer_{i}"] = {
            "norm1": _layernorm(sd, lp + "norm1"),
            "norm2": _layernorm(sd, lp + "norm2"),
            "attention": attn,
            "layer_scale1": sd[lp + "ls1.gamma"],
            "layer_scale2": sd[lp + "ls2.gamma"],
            "mlp": mlp,
        }
    return params


def _convert_da3_fusion_chain(sd: Mapping[str, np.ndarray], prefix: str, aux: bool) -> Params:
    """refinenet{4..1}(_aux) → fusion(_aux)_{0..3}; refinenet4 has no
    resConfUnit1 (it never receives a residual)."""
    tag = "_aux" if aux else ""
    chain: Params = {}
    for j, rnum in enumerate((4, 3, 2, 1)):
        fp = f"{prefix}refinenet{rnum}{tag}."
        layer: Params = {"projection": _conv(sd, fp + "out_conv"),
                         "res2": {"conv1": _conv(sd, fp + "resConfUnit2.conv1"),
                                  "conv2": _conv(sd, fp + "resConfUnit2.conv2")}}
        if j > 0:
            layer["res1"] = {"conv1": _conv(sd, fp + "resConfUnit1.conv1"),
                             "conv2": _conv(sd, fp + "resConfUnit1.conv2")}
        chain[f"fusion{tag}_{j}"] = layer
    return chain


def convert_da3(state_dict: Any, spec: ModelSpec) -> Params:
    """A Depth-Anything-3 checkpoint (model.backbone.pretrained.*, model.head.*,
    model.cam_dec.*, or the same without `model.`) → DepthAnything3 param
    tree."""
    sd = to_numpy_state_dict(state_dict)
    for p in ("model.", ""):
        if any(k.startswith(p + "backbone.") for k in sd):
            sd = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
            break
    anyview = da3_mode(spec.name) == "anyview"

    head: Params = {"reassemble": {}}
    hp = "head."
    if anyview:
        head["reassemble"]["norm"] = _layernorm(sd, hp + "norm")
    for i in range(4):
        head["reassemble"][f"project_{i}"] = _conv(sd, f"{hp}projects.{i}")
        if i in (0, 1):  # ConvTranspose2d (in,out,f,f) as it is
            head["reassemble"][f"resize_{i}"] = {"kernel": sd[f"{hp}resize_layers.{i}.weight"],
                                                 "bias": sd[f"{hp}resize_layers.{i}.bias"]}
        elif i == 3:
            head["reassemble"]["resize_3"] = _conv(sd, f"{hp}resize_layers.3")
        head[f"conv_{i}"] = _conv(sd, f"{hp}scratch.layer{i + 1}_rn", bias=False)

    sp = hp + "scratch."
    head["main"] = _convert_da3_fusion_chain(sd, sp, aux=False)
    head["head_conv1"] = _conv(sd, sp + "output_conv1")
    head["head_conv2"] = _conv(sd, sp + "output_conv2.0")
    head["head_conv3"] = _conv(sd, sp + "output_conv2.2")
    if anyview:
        head["aux"] = _convert_da3_fusion_chain(sd, sp, aux=True)
        for k in range(5):
            head[f"aux_conv1_{k}"] = _conv(sd, f"{sp}output_conv1_aux.3.{k}")
        head["aux_conv2"] = _conv(sd, sp + "output_conv2_aux.3.0")
        head["aux_ln"] = _layernorm(sd, sp + "output_conv2_aux.3.2")
        head["aux_conv3"] = _conv(sd, sp + "output_conv2_aux.3.5")
    else:
        head["sky_conv2"] = _conv(sd, sp + "sky_output_conv2.0")
        head["sky_conv3"] = _conv(sd, sp + "sky_output_conv2.2")

    params: Params = {
        "backbone": _convert_da3_backbone(sd, spec, anyview, "backbone.pretrained."),
        "head": head,
    }
    if anyview and "cam_dec.fc_t.weight" in sd:
        params["cam_dec"] = {"fc0": _linear(sd, "cam_dec.backbone.0"),
                             "fc1": _linear(sd, "cam_dec.backbone.2"),
                             "fc_t": _linear(sd, "cam_dec.fc_t"),
                             "fc_qvec": _linear(sd, "cam_dec.fc_qvec"),
                             "fc_fov": _linear(sd, "cam_dec.fc_fov.0")}
    return params


def convert_da3_nested(state_dict: Any, spec: ModelSpec) -> Params:
    """DA3NESTED checkpoint → {"da3": anyview tree, "da3_metric": metric
    tree}.  The branches sit under model.da3.* and model.da3_metric.*, each
    with or without a further `model.` (the JAX build_da3_nested's prefix
    handling); the metric branch converts as DA3METRIC-LARGE."""
    sd = to_numpy_state_dict(state_dict)

    def branch(name: str, branch_spec: ModelSpec) -> Params:
        prefix = f"model.{name}.model."
        if not any(k.startswith(prefix) for k in sd):
            prefix = f"model.{name}."
        return convert_da3({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                           branch_spec)

    metric_spec = dataclasses.replace(spec, name="DA3METRIC-LARGE", variant="vitl")
    return {"da3": branch("da3", spec), "da3_metric": branch("da3_metric", metric_spec)}


# ---- the classic DPT family: dpt-large, DPT-DINOv2, DPT-BEiT, dpt-hybrid ----------

def _fused_qkv(sd: Mapping[str, np.ndarray], ap: str) -> Params:
    """HF query/key/value Linears under `ap` → one fused qkv Dense."""
    return {"kernel": np.ascontiguousarray(np.concatenate(
                [sd[ap + n + ".weight"] for n in ("query", "key", "value")], axis=0).T),
            "bias": np.concatenate([sd[ap + n + ".bias"] for n in ("query", "key", "value")])}


def _convert_vit_layer(sd: Mapping[str, np.ndarray], lp: str) -> Params:
    """HF ViTLayer (dpt.encoder.layer.{i}.) → ViTLayer params."""
    return {"norm1": _layernorm(sd, lp + "layernorm_before"),
            "norm2": _layernorm(sd, lp + "layernorm_after"),
            "qkv": _fused_qkv(sd, lp + "attention.attention."),
            "proj": _linear(sd, lp + "attention.output.dense"),
            "fc1": _linear(sd, lp + "intermediate.dense"),
            "fc2": _linear(sd, lp + "output.dense")}


def convert_classic_dpt_decoder(sd: Mapping[str, np.ndarray],
                                head_prefix: Optional[str] = "head.head.") -> Params:
    """HF DPTNeck (readout-project) + DPTDepthEstimationHead →
    ClassicDPTDecoder params (dpt-large, DPT-DINOv2, DPT-BEiT, and ZoeDepth's
    relative head, which passes head_prefix=None and converts its own)."""
    dec = convert_dpt_neck(sd)
    for i in range(4):
        dec[f"readout_{i}"] = _linear(sd, f"neck.reassemble_stage.readout_projects.{i}.0")
    if head_prefix is not None:
        for n, idx in (("head_conv1", 0), ("head_conv2", 2), ("head_conv3", 4)):
            dec[n] = _conv(sd, f"{head_prefix}{idx}")
    return dec


def convert_dpt_vit(state_dict: Any, spec: ModelSpec) -> Params:
    """HF DPTForDepthEstimation (plain ViT, e.g. Intel/dpt-large) → DPTViT
    params."""
    from desktop2stereo_tpu_torch.models.dpt_vit import DPT_VIT_PRESETS

    sd = to_numpy_state_dict(state_dict)
    D, num_layers, _, _, _ = DPT_VIT_PRESETS[spec.variant]
    ep = "dpt.embeddings."
    pw = sd[ep + "patch_embeddings.projection.weight"]  # (D,3,p,p)
    params: Params = {
        "cls_token": sd[ep + "cls_token"],
        "position_embeddings": sd[ep + "position_embeddings"],
        "patch_kernel": np.ascontiguousarray(pw.transpose(2, 3, 1, 0).reshape(-1, D)),
        "patch_bias": sd[ep + "patch_embeddings.projection.bias"],
    }
    for i in range(num_layers):
        params[f"layer_{i}"] = _convert_vit_layer(sd, f"dpt.encoder.layer.{i}.")
    params["decoder"] = convert_classic_dpt_decoder(sd)
    return params


def _convert_beit_backbone(sd: Mapping[str, np.ndarray], D: int, num_layers: int,
                           prefix: str = "backbone.") -> Params:
    pw = sd[prefix + "embeddings.patch_embeddings.projection.weight"]
    backbone: Params = {
        "cls_token": sd[prefix + "embeddings.cls_token"],
        "patch_kernel": np.ascontiguousarray(pw.transpose(2, 3, 1, 0).reshape(-1, D)),
        "patch_bias": sd[prefix + "embeddings.patch_embeddings.projection.bias"],
    }
    for i in range(num_layers):
        lp = f"{prefix}encoder.layer.{i}."
        ap = lp + "attention.attention."
        backbone[f"layer_{i}"] = {
            "norm1": _layernorm(sd, lp + "layernorm_before"),
            "norm2": _layernorm(sd, lp + "layernorm_after"),
            "query": _linear(sd, ap + "query"),
            "key": {"kernel": np.ascontiguousarray(sd[ap + "key.weight"].T)},  # no bias
            "value": _linear(sd, ap + "value"),
            "relative_position_bias": {"relative_position_bias_table": sd[
                ap + "relative_position_bias.relative_position_bias_table"]},
            "proj": _linear(sd, lp + "attention.output.dense"),
            "fc1": _linear(sd, lp + "intermediate.dense"),
            "fc2": _linear(sd, lp + "output.dense"),
            "lambda_1": sd[lp + "lambda_1"],
            "lambda_2": sd[lp + "lambda_2"],
        }
    return backbone


def convert_dpt_dinov2(state_dict: Any, spec: ModelSpec) -> Params:
    """HF DPTForDepthEstimation + Dinov2Backbone (facebook/dpt-dinov2-*) →
    DPTDinov2 params: the DINOv2 trunk as Depth-Anything's (prefix
    "backbone."; ViT-G's SwiGLU MLP as `weights_in` / `weights_out`, which
    the JAX converter leaves out), the classic decoder."""
    sd = to_numpy_state_dict(state_dict)
    _, num_layers, _, _ = spec.dims
    return {"backbone": convert_dinov2_backbone(sd, num_layers,
                                                use_swiglu=spec.variant == "vitg",
                                                prefix="backbone."),
            "decoder": convert_classic_dpt_decoder(sd)}


def convert_dpt_beit(state_dict: Any, spec: ModelSpec) -> Params:
    """HF DPTForDepthEstimation + BeitBackbone (Intel/dpt-beit-*) → DPTBEiT
    params."""
    from desktop2stereo_tpu_torch.models.beit import BEIT_PRESETS

    sd = to_numpy_state_dict(state_dict)
    D, num_layers = BEIT_PRESETS[spec.name][:2]
    return {"backbone": _convert_beit_backbone(sd, D, num_layers),
            "decoder": convert_classic_dpt_decoder(sd)}


def _convert_projector(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {"conv1": _conv(sd, prefix + "conv1"), "conv2": _conv(sd, prefix + "conv2")}


def convert_zoedepth(state_dict: Any, spec: ModelSpec) -> Params:
    """HF ZoeDepthForDepthEstimation (Intel/zoedepth-*) → ZoeDepth params:
    the BEiT trunk, the classic decoder with `relative_head.conv1-3` as its
    head, and the metric head (one bin configuration, or two with the patch
    transformer and the domain classifier)."""
    from desktop2stereo_tpu_torch.models.beit import BEIT_PRESETS
    from desktop2stereo_tpu_torch.models.zoedepth import ZOE_PRESETS

    sd = to_numpy_state_dict(state_dict)
    configs, multi = ZOE_PRESETS[spec.name]
    D, num_layers = BEIT_PRESETS["zoedepth"][:2]
    decoder = convert_classic_dpt_decoder(sd, head_prefix=None)
    for n in ("conv1", "conv2", "conv3"):
        decoder[f"head_{n}"] = _conv(sd, f"relative_head.{n}")

    m = "metric_head."
    mh: Params = {"conv2": _conv(sd, m + "conv2"),
                  "seed_projector": _convert_projector(sd, m + "seed_projector.")}
    for i in range(4):
        mh[f"projector_{i}"] = _convert_projector(sd, f"{m}projectors.{i}.")
    if not multi:
        mh["seed_bin_regressor"] = _convert_projector(sd, m + "seed_bin_regressor.")
        for i in range(4):
            mh[f"attractor_{i}"] = _convert_projector(sd, f"{m}attractors.{i}.")
        mh["conditional_log_binomial"] = {
            "mlp_conv1": _conv(sd, m + "conditional_log_binomial.mlp.0"),
            "mlp_conv2": _conv(sd, m + "conditional_log_binomial.mlp.2")}
    else:
        for name, *_ in configs:
            mh[f"seed_bin_regressor_{name}"] = _convert_projector(
                sd, f"{m}seed_bin_regressors.{name}.")
            for i in range(4):
                mh[f"attractor_{name}_{i}"] = _convert_projector(
                    sd, f"{m}attractors.{name}.{i}.")
            mh[f"conditional_log_binomial_{name}"] = {
                "mlp_conv1": _conv(sd, f"{m}conditional_log_binomial.{name}.mlp.0"),
                "mlp_conv2": _conv(sd, f"{m}conditional_log_binomial.{name}.mlp.2")}
        pt: Params = {"embedding": _conv(sd, m + "patch_transformer.embedding_convPxP")}
        for li in range(4):
            tp = f"{m}patch_transformer.transformer_encoder.{li}."
            for n, src in (("q", "self_attn.query"), ("k", "self_attn.key"),
                           ("v", "self_attn.value"), ("out", "self_attn.out_proj"),
                           ("fc1", "linear1"), ("fc2", "linear2")):
                pt[f"{n}_{li}"] = _linear(sd, tp + src)
            pt[f"norm1_{li}"] = _layernorm(sd, tp + "norm1")
            pt[f"norm2_{li}"] = _layernorm(sd, tp + "norm2")
        mh["patch_transformer"] = pt
        mh["classifier_fc1"] = _linear(sd, m + "mlp_classifier.linear1")
        mh["classifier_fc2"] = _linear(sd, m + "mlp_classifier.linear2")
    return {"backbone": _convert_beit_backbone(sd, D, num_layers), "decoder": decoder,
            "metric_head": mh}


def convert_dpt_hybrid(state_dict: Any, spec: ModelSpec, depths=(3, 4, 9),
                       num_layers: int = 12) -> Params:
    """HF DPTForDepthEstimation(is_hybrid=True) → DPTHybrid params."""
    sd = to_numpy_state_dict(state_dict)

    def ws(prefix):  # a weight-standardized conv: kernel only
        return {"kernel": np.ascontiguousarray(sd[prefix + ".weight"].transpose(2, 3, 1, 0))}

    def gn(prefix):  # GroupNormAct's GroupNorm: weight/bias → scale/bias
        return {"norm": _layernorm(sd, prefix)}

    bp = "dpt.embeddings.backbone.bit."
    bit: Params = {"stem": {"conv": ws(bp + "embedder.convolution"),
                            "norm": gn(bp + "embedder.norm")}}
    for s, depth in enumerate(depths):
        for l in range(depth):
            lp = f"{bp}encoder.stages.{s}.layers.{l}."
            layer: Params = {}
            for ci in (1, 2, 3):
                layer[f"conv{ci}"] = ws(lp + f"conv{ci}")
                layer[f"norm{ci}"] = gn(lp + f"norm{ci}")
            if lp + "downsample.conv.weight" in sd:
                layer["downsample_conv"] = ws(lp + "downsample.conv")
                layer["downsample_norm"] = gn(lp + "downsample.norm")
            bit[f"stage{s}_layer{l}"] = layer

    params: Params = {
        "bit": bit,
        "projection": _conv(sd, "dpt.embeddings.projection"),
        "cls_token": sd["dpt.embeddings.cls_token"],
        "position_embeddings": sd["dpt.embeddings.position_embeddings"],
    }
    for i in range(num_layers):
        params[f"layer_{i}"] = _convert_vit_layer(sd, f"dpt.encoder.layer.{i}.")
    for si in (2, 3):
        params[f"readout_{si}"] = _linear(sd, f"neck.reassemble_stage.readout_projects.{si}.0")
        rp = f"neck.reassemble_stage.layers.{si}."
        layer = {"projection": _conv(sd, rp + "projection")}
        if rp + "resize.weight" in sd:  # stage 3's stride-2 conv
            layer["resize"] = _conv(sd, rp + "resize")
        params[f"reassemble_{si}"] = layer
    for i in range(4):
        params[f"conv_{i}"] = _conv(sd, f"neck.convs.{i}", bias=False)
    params.update(_convert_fusion_stage(sd))
    for n, idx in (("head_conv1", 0), ("head_conv2", 2), ("head_conv3", 4)):
        params[n] = _conv(sd, f"head.head.{idx}")
    return params


def convert_depthpro(state_dict: Any, spec: ModelSpec, num_layers: int = 24) -> Params:
    """HF DepthProForDepthEstimation → DepthPro params: the two DINOv2
    towers, the upsample blocks (1x1 projections HWIO, ConvTransposes kept
    (C, O, 2, 2)), the projections, the fusion stage and the head; the FOV
    branch's weights are left out (the frame path reads depth only)."""
    from desktop2stereo_tpu_torch.models.depthpro import HOOK_IDS, SCALED_DIMS

    sd = to_numpy_state_dict(state_dict)
    n_scaled, n_hooks = len(SCALED_DIMS), len(HOOK_IDS)
    params: Params = {
        "patch_encoder": convert_dinov2_backbone(
            sd, num_layers, prefix="depth_pro.encoder.patch_encoder.model."),
        "image_encoder": convert_dinov2_backbone(
            sd, num_layers, prefix="depth_pro.encoder.image_encoder.model."),
    }
    up = "depth_pro.neck.feature_upsample."

    def upsample_block(prefix: str, n_layers: int, bias: bool) -> Params:
        block: Params = {}
        for li in range(n_layers):
            w = sd[f"{prefix}layers.{li}.weight"]
            if w.ndim == 4 and w.shape[2:] == (1, 1):      # 1x1 Conv2d (out, in, 1, 1)
                entry: Params = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
            else:                                          # ConvTranspose2d (in, out, 2, 2)
                entry = {"kernel": w}
            if bias and f"{prefix}layers.{li}.bias" in sd:
                entry["bias"] = sd[f"{prefix}layers.{li}.bias"]
            block[f"layers_{li}"] = entry
        return block

    params["image_block"] = upsample_block(up + "image_block.", 1, bias=True)
    for i in range(n_scaled):
        params[f"scaled_{i}"] = upsample_block(up + f"scaled_images.{i}.", 2, bias=False)
    for i in range(n_hooks):
        params[f"intermediate_{i}"] = upsample_block(up + f"intermediate.{i}.", 3 + i,
                                                     bias=False)
    params["fuse_image_low_res"] = _conv(sd, "depth_pro.neck.fuse_image_with_low_res")
    for i in range(4):
        pp = f"depth_pro.neck.feature_projection.projections.{i}"
        if pp + ".weight" in sd:
            params[f"projection_{i}"] = _conv(sd, pp, bias=False)

    def residual(fp: str, r: int) -> Params:
        return {f"conv{c}": _conv(sd, f"{fp}residual_layer{r}.convolution{c}") for c in (1, 2)}

    for j in range(n_scaled + n_hooks - 1):
        fp = f"fusion_stage.intermediate.{j}."
        layer: Params = {"res2": residual(fp, 2), "deconv": {"kernel": sd[fp + "deconv.weight"]},
                         "projection": _conv(sd, fp + "projection")}
        if j > 0:  # the first fusion layer takes no residual
            layer["res1"] = residual(fp, 1)
        params[f"fusion_{j}"] = layer
    fp = "fusion_stage.final."
    params["fusion_final"] = {"res1": residual(fp, 1), "res2": residual(fp, 2),
                              "projection": _conv(sd, fp + "projection")}
    params["head_conv1"] = _conv(sd, "head.layers.0")
    params["head_deconv"] = {"kernel": sd["head.layers.1.weight"],
                             "bias": sd["head.layers.1.bias"]}
    params["head_conv2"] = _conv(sd, "head.layers.2")
    params["head_conv3"] = _conv(sd, "head.layers.4")
    return params


def convert_infinidepth(state_dict: Any, spec: ModelSpec) -> Params:
    """InfiniDepth checkpoint (`pretrained.*` DINOv3, `basic_encoder.*`,
    `depth_implicit_head.*`, optionally under `model.`) → InfiniDepth
    params.  The k part of a masked qkv bias (`attn.qkv.bias_mask`, NaN
    where the bias stays) is folded into the fused bias."""
    from desktop2stereo_tpu_torch.models.infinidepth import DINOV3_CONFIGS, ENCODER_BY_NAME

    sd = to_numpy_state_dict(state_dict)
    if any(k.startswith("model.pretrained.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    D, depth, _, _, swiglu = DINOV3_CONFIGS[ENCODER_BY_NAME[spec.name]]
    bp = "pretrained."
    pw = sd[bp + "patch_embed.proj.weight"]
    backbone: Params = {
        "cls_token": sd[bp + "cls_token"],
        "storage_tokens": sd[bp + "storage_tokens"],
        "patch_kernel": np.ascontiguousarray(pw.transpose(2, 3, 1, 0).reshape(-1, D)),
        "patch_bias": sd[bp + "patch_embed.proj.bias"],
        "norm": _layernorm(sd, bp + "norm"),
    }
    for i in range(depth):
        lp = f"{bp}blocks.{i}."
        qkv_b = sd.get(lp + "attn.qkv.bias")
        mask = sd.get(lp + "attn.qkv.bias_mask")
        if qkv_b is not None and mask is not None:
            qkv_b = qkv_b * np.nan_to_num(mask, nan=1.0)
        qkv: Params = {"kernel": np.ascontiguousarray(sd[lp + "attn.qkv.weight"].T)}
        if qkv_b is not None:
            qkv["bias"] = qkv_b
        mlp = ({n: _linear(sd, f"{lp}mlp.{n}") for n in ("w1", "w2", "w3")} if swiglu
               else {n: _linear(sd, f"{lp}mlp.{n}") for n in ("fc1", "fc2")})
        backbone[f"layer_{i}"] = {
            "norm1": _layernorm(sd, lp + "norm1"), "norm2": _layernorm(sd, lp + "norm2"),
            "qkv": qkv, "proj": _linear(sd, lp + "attn.proj"),
            "layer_scale1": sd[lp + "ls1.gamma"], "layer_scale2": sd[lp + "ls2.gamma"], **mlp}
    be = "basic_encoder."
    basic: Params = {n: _conv(sd, be + n) for n in ("conv1", "conv2", "conv3")}
    for li in range(1, 5):
        for bi in range(2):
            bl = f"{be}layer{li}.{bi}."
            blk: Params = {"conv1": _conv(sd, bl + "conv1"), "conv2": _conv(sd, bl + "conv2")}
            if bl + "downsample.0.weight" in sd:
                blk["downsample"] = _conv(sd, bl + "downsample.0")
            basic[f"layer{li}_{bi}"] = blk
    hp = "depth_implicit_head.out_layer.layers."
    head: Params = {"mlp_0": _linear(sd, hp + "0"), "mlp_1": _linear(sd, hp + "2"),
                    "mlp_2": _linear(sd, hp + "4"), "mlp_out": _linear(sd, hp + "6")}
    return {"backbone": backbone, "basic_encoder": basic, "head": head}


def param_count(model: Any) -> int:
    """The elements of a built model's weights: the counterpart of the JAX
    package's `param_count(params)` on the same registry model.  It counts
    the state dict, every parameter and persistent buffer once: the leaves
    of the JAX tree that `from_flax` loads, QuantLinear's `weight_q`, `scale`
    and `bias` buffers included (the JAX QuantDense's `kernel_q`, `scale`
    and `bias`).  Left out are non-persistent buffers and the per-shape
    caches (RoPE tables, BEiT's interpolated relative-position tables, the
    resize tables): they are derived at run time and no JAX leaf holds
    them."""
    seen = {id(t): t for t in model.state_dict(keep_vars=True).values()}
    return sum(int(t.numel()) for t in seen.values())
