"""Model factory: registry name → (model, spec), weights from a checkpoint or
from a seed.

Port of `desktop2stereo_tpu/models/factory.py:build_bound` for every family
of the registry.  Weights come, in the JAX factory's order,
from an explicit checkpoint path, then from a local cache
(`find_checkpoint`), then from a seeded draw (printing the JAX factory's
"no checkpoint found" line).  A checkpoint (safetensors, one file or
sharded) goes through the family's converter (`models/convert_hf.py`, the
JAX converters' copy) and `models/from_flax.py`, so it reaches the port
through the same names as the JAX package.  The seeded draw uses a
`torch.Generator` with flax's default initializers (truncated-normal lecun
kernels, zero biases, unit norms and LayerScale, zero cls/position tables,
a unit-normal DA3 camera token and unit-normal BEiT relative-position
tables).  `quant="int8"` quantizes the encoder's dense weights at load
(`ops/quant.py:quantize_state_dict`) within each family's scope, as the JAX
builders' `quantize_tree` step does (the ViT layers themselves for dpt and
dpt_hybrid, DepthPro's two towers, `backbone` for the others); DA3NESTED
refuses it, as JAX does; every other family takes it (the JAX
`QUANT_FAMILIES` lists them all).
`quant="none"` is float for every family: the JAX `build_model` hands
`build_dpt_dinov2` the string, so its DPT-DINOv2 models run int8 even then
(ROADMAP C5); the port does not follow it there.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Optional, Tuple

import torch
import torch.nn as nn

from desktop2stereo_tpu_torch.core.registry import ModelSpec, get_spec, is_da3_nested
from desktop2stereo_tpu_torch.core.runtime import COMPUTE_DTYPE, cuda_policy
from desktop2stereo_tpu_torch.models import da3
from desktop2stereo_tpu_torch.models.beit import BeitEncoder, BeitRelativePositionBias, DPTBEiT
from desktop2stereo_tpu_torch.models.convert_hf import (
    convert_da3, convert_da3_nested, convert_depth_anything, convert_depthpro, convert_dpt_beit,
    convert_dpt_dinov2, convert_dpt_hybrid, convert_dpt_vit, convert_infinidepth, convert_vda,
    convert_zoedepth)
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.depthpro import DepthPro
from desktop2stereo_tpu_torch.models.dinov2 import PatchEmbed
from desktop2stereo_tpu_torch.models.dpt import ConvTransposeSameStride
from desktop2stereo_tpu_torch.models.dpt_hybrid import DPTHybrid
from desktop2stereo_tpu_torch.models.dpt_vit import DPTDinov2, DPTViT
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.models.infinidepth import Dinov3Backbone, InfiniDepth
from desktop2stereo_tpu_torch.models.safetensors_io import INDEX_NAME
from desktop2stereo_tpu_torch.models.vda import VideoDepthAnything
from desktop2stereo_tpu_torch.models.zoedepth import ZoeDepth
from desktop2stereo_tpu_torch.ops.quant import quantize_state_dict

QUANT_MODES = ("none", "int8")

# where converted checkpoints are looked for (the reference keeps them in
# ./models), before the Hugging Face cache
DEFAULT_WEIGHTS_DIRS = ("./models", os.path.expanduser("~/.cache/desktop2stereo_tpu/models"))

NESTED_QUANT_MESSAGE = ("--quant is not supported for the NESTED preset (two aligned "
                        "branches); use DA3METRIC/DA3-* instead")


def _convert_da3(ckpt, spec: ModelSpec):
    return (convert_da3_nested if is_da3_nested(spec) else convert_da3)(ckpt, spec)


# family → (`from_spec(spec, quant=False)` making the model, checkpoint converter)
FAMILIES = {"depth_anything": (DepthAnything.from_spec, convert_depth_anything),
            "vda": (VideoDepthAnything.from_spec, convert_vda),
            "da3": (da3.from_spec, _convert_da3),
            "dpt": (DPTViT.from_spec, convert_dpt_vit),
            "dpt_dinov2": (DPTDinov2.from_spec, convert_dpt_dinov2),
            "dpt_hybrid": (DPTHybrid.from_spec, convert_dpt_hybrid),
            "dpt_beit": (DPTBEiT.from_spec, convert_dpt_beit),
            "zoedepth": (ZoeDepth.from_spec, convert_zoedepth),
            "depthpro": (DepthPro.from_spec, convert_depthpro),
            "infinidepth": (InfiniDepth.from_spec, convert_infinidepth)}

# the module names `quant="int8"` quantizes beneath (`quantize_state_dict`'s
# scope): the ViT layers sit at the model's top level in dpt and dpt_hybrid,
# as the JAX builders' `layer_{i}` scopes say; DepthPro's two ViT towers;
# "backbone" elsewhere (ZoeDepth's metric head, its patch transformer among
# it, stays float)
QUANT_SCOPES = {"dpt": ("layer",), "dpt_hybrid": ("layer",),
                "depthpro": ("patch_encoder", "image_encoder")}

# std of N(0,1) truncated to ±2, the correction flax's truncated_normal
# initializer divides by so the drawn variance is the requested one
_TRUNC_STD = 0.87962566103423978


def _lecun_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded flax-style init of every kernel (biases and tables as built).
    VDA's `proj_out`, which flax initialises to zero, is drawn like every
    other kernel, so that a run on random weights goes through the temporal
    modules rather than around them.  A DA3 trunk's patch kernel is drawn
    as a kernel and its camera token from N(0, 1); a DA3Nested draws its
    anyview branch from `seed` and its metric branch from `seed + 1`.  The
    DPTViT and BEiT patch kernels are drawn as kernels, and BEiT's
    relative-position tables (zeros in flax) from N(0, 1)."""
    if isinstance(model, da3.DA3Nested):
        init_random(model.da3, seed)
        init_random(model.da3_metric, seed + 1)
        return model
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _lecun_(m.weight, m.in_features, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            _lecun_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, PatchEmbed):
            _lecun_(m.weight, m.weight.shape[1], gen)
        elif isinstance(m, ConvTransposeSameStride):
            _lecun_(m.weight, m.weight.shape[0], gen)
        elif isinstance(m, da3.DA3Backbone):
            _lecun_(m.patch_kernel, m.patch_kernel.shape[0], gen)
            if hasattr(m, "camera_token"):
                m.camera_token.normal_(generator=gen)
        elif isinstance(m, (DPTViT, BeitEncoder, Dinov3Backbone)):
            _lecun_(m.patch_kernel, m.patch_kernel.shape[0], gen)
        elif isinstance(m, BeitRelativePositionBias):
            # flax draws zeros; unit normal so that a run on random weights
            # adds a bias that moves the attention
            m.relative_position_bias_table.normal_(generator=gen)
    return model


def _resolve_in_dir(d: str) -> Optional[str]:
    """model.safetensors in `d`, else a sharded checkpoint's index json,
    else its first shard (the loader globs the siblings)."""
    single = os.path.join(d, "model.safetensors")
    if os.path.exists(single):
        return single
    idx = os.path.join(d, INDEX_NAME)
    if os.path.exists(idx):
        return idx
    shards = sorted(glob.glob(os.path.join(d, "model-*-of-*.safetensors")))
    return shards[0] if shards else None


def find_checkpoint(spec: ModelSpec) -> Optional[str]:
    """A local safetensors checkpoint for `spec`, single-file or sharded:
    `<dir>/<name>.safetensors`, `<dir>/<org--repo>/` or `<dir>/<name>/` in
    each of DEFAULT_WEIGHTS_DIRS, then the snapshots of the Hugging Face hub
    cache (`$HF_HOME`, else ~/.cache/huggingface)."""
    repo_flat = spec.hf_repo.replace("/", "--")
    dirs = []
    for d in DEFAULT_WEIGHTS_DIRS:
        dirs += [os.path.join(d, repo_flat), os.path.join(d, spec.name)]
        flat = os.path.join(d, f"{spec.name}.safetensors")
        if os.path.exists(flat):
            return flat
    hf_cache = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    hub_dir = os.path.join(hf_cache, "hub", f"models--{repo_flat}", "snapshots")
    if os.path.isdir(hub_dir):
        for snap in sorted(os.listdir(hub_dir)):
            dirs.append(os.path.join(hub_dir, snap))
    for d in dirs:
        if os.path.isdir(d):
            hit = _resolve_in_dir(d)
            if hit is not None:
                return hit
    return None


def build_bound(name: str, device: Optional[torch.device | str] = None,
                dtype: Optional[torch.dtype] = None, seed: int = 0,
                quant: str = "none", checkpoint: Optional[str] = None
                ) -> Tuple[nn.Module, ModelSpec]:
    """Registry name → (eval-mode model on `device` in `dtype`, spec).

    `checkpoint` is a safetensors path (a file, an index json or one shard);
    without one, `find_checkpoint` looks in the local caches, and without a
    hit the weights are drawn from `seed`.  A `checkpoint` that does not
    exist raises FileNotFoundError.  A vda, dpt_beit or zoedepth model is
    stateful: it exposes `first(pixels)` and `step(pixels, carry)` beside
    `forward` (VDA carries its temporal window, DPT-BEiT and ZoeDepth their
    layers' interpolated relative-position tables, [H, R] each, which the
    attention kernel gathers its bias from).

    `device=None` is the CUDA device policy's (`cuda_policy()`, which raises
    without CUDA); a caller that wants the CPU says so.  `dtype=None` is the
    policy's compute dtype on a CUDA device and float32 on the CPU.  The
    weights are loaded or drawn on the CPU in f32, so one checkpoint or seed
    gives the same model on every device.  `quant="int8"` quantizes the
    float weights' encoder products in f32 on the CPU and loads them into
    the int8 model; its `scale` and `bias` buffers stay f32 in any
    `dtype`."""
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r} ({'|'.join(QUANT_MODES)})")
    spec = get_spec(name)
    if quant != "none" and is_da3_nested(spec):
        raise NotImplementedError(NESTED_QUANT_MESSAGE)
    if device is None:
        device = cuda_policy().device
    if dtype is None:
        dtype = COMPUTE_DTYPE if torch.device(device).type == "cuda" else torch.float32
    make, convert = FAMILIES[spec.family]
    ckpt = checkpoint or find_checkpoint(spec)
    if ckpt is not None:
        model = make(spec)
        model.load_state_dict(from_flax(convert(ckpt, spec)), strict=True)
    else:
        model = init_random(make(spec), seed)
        print(f"[models] no checkpoint found for {name}; using random init")
    if quant == "int8":
        state = quantize_state_dict(model.state_dict(),
                                    QUANT_SCOPES.get(spec.family, "backbone"))
        model = make(spec, quant=True)
        model.load_state_dict(state, strict=True)
    return model.to(device=device, dtype=dtype).eval(), spec
