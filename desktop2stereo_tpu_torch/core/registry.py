"""Model registry for the port: every family of the JAX registry
(Depth-Anything, Video-Depth-Anything, Depth-Anything-3, the classic DPT
family, ZoeDepth, DepthPro and InfiniDepth), 52 names.

The same `ModelSpec` facts as `desktop2stereo_tpu/core/registry.py` (family,
ViT variant, patch size, normalization, metric-ness, HF repo, resolution
menu, square-only input).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

# ViT variant dims: (hidden, layers, heads, mlp_dim)
VIT_VARIANTS = {
    "vits": (384, 12, 6, 1536),
    "vitsplus": (384, 12, 6, 2304),
    "vitb": (768, 12, 12, 3072),
    "vitl": (1024, 24, 16, 4096),
    "vitg": (1536, 40, 24, 6144),
}

# Encoder layers (0-indexed outputs) that feed the DPT neck, per variant.
DPT_LAYER_IDS = {
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (4, 11, 17, 23),
    "vitg": (9, 19, 29, 39),
}

# DPT neck channel pyramid per variant (HF DepthAnythingConfig.neck_hidden_sizes).
NECK_CHANNELS = {
    "vits": (48, 96, 192, 384),
    "vitb": (96, 192, 384, 768),
    "vitl": (256, 512, 1024, 1024),
    "vitg": (384, 768, 1536, 1536),
}
FUSION_CHANNELS = {"vits": 64, "vitb": 128, "vitl": 256, "vitg": 384}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str
    variant: str
    hf_repo: str
    patch_size: int = 14
    metric: bool = False
    max_depth: float = 1.0
    norm_family: str = "imagenet"
    resolutions: Optional[Tuple[int, ...]] = None
    square_only: bool = False
    force_fp32: bool = False

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        return VIT_VARIANTS[self.variant]

    @property
    def dpt_layers(self) -> Tuple[int, ...]:
        return DPT_LAYER_IDS[self.variant]

    @property
    def neck_channels(self) -> Tuple[int, ...]:
        return NECK_CHANNELS[self.variant]

    @property
    def fusion_channels(self) -> int:
        return FUSION_CHANNELS[self.variant]


# Per-family depth-resolution menus (the JAX registry's family menu table)
_DA_MENU = (196, 238, 294, 336, 392, 448, 518)   # patch-14 DA/VDA/Distill
_DA3_MENU = (182, 224, 280, 322, 378, 434, 504)  # patch-14 DA3 spread
_INFINI_MENU = (192, 240, 304, 336, 384, 448, 512)  # patch-16 InfiniDepth
_P16_MENU = (256, 320, 384, 448, 512)            # classic DPT-era models
_FAMILY_MENUS = {"depth_anything": _DA_MENU, "dpt_dinov2": _DA_MENU, "vda": _DA_MENU,
                 "da3": _DA3_MENU, "infinidepth": _INFINI_MENU, "dpt": _P16_MENU,
                 "dpt_hybrid": _P16_MENU, "dpt_beit": _P16_MENU, "zoedepth": _P16_MENU}

_SIZE = {"small": "vits", "base": "vitb", "large": "vitl", "giant": "vitg"}

MODEL_REGISTRY: Dict[str, ModelSpec] = {}


def _register(name: str, variant: str, repo: str, metric: bool = False,
              max_depth: float = 1.0, family: str = "depth_anything",
              patch_size: int = 14, norm_family: str = "imagenet",
              resolutions: Optional[Tuple[int, ...]] = None, square_only: bool = False) -> None:
    MODEL_REGISTRY[name] = ModelSpec(
        name=name, family=family, variant=variant, hf_repo=repo, patch_size=patch_size,
        metric=metric, max_depth=max_depth, norm_family=norm_family,
        resolutions=resolutions or _FAMILY_MENUS[family], square_only=square_only)


for _size in ("Small", "Base", "Large"):
    _v = _SIZE[_size.lower()]
    _register(f"Depth-Anything-V2-{_size}", _v,
              f"depth-anything/Depth-Anything-V2-{_size}-hf")
    _register(f"Depth-Anything-V2-Metric-Outdoor-{_size}", _v,
              f"depth-anything/Depth-Anything-V2-Metric-Outdoor-{_size}-hf",
              metric=True, max_depth=80.0)
    _register(f"Depth-Anything-V2-Metric-Indoor-{_size}", _v,
              f"depth-anything/Depth-Anything-V2-Metric-Indoor-{_size}-hf",
              metric=True, max_depth=20.0)

for _size in ("small", "base", "large"):
    _register(f"depth-anything-{_size}", _SIZE[_size],
              f"LiheYoung/depth-anything-{_size}-hf")
_register("depth-anything-indoor-large", "vitl",
          "lc700x/depth-anything-indoor-large-hf", metric=True)
_register("depth-anything-outdoor-large", "vitl",
          "lc700x/depth-anything-outdoor-large-hf", metric=True)

for _size in ("Small", "Base", "Large"):
    _owner = "lc700x" if _size == "Base" else "xingyang1"
    _register(f"Distill-Any-Depth-{_size}", _SIZE[_size.lower()],
              f"{_owner}/Distill-Any-Depth-{_size}-hf")

# Video-Depth-Anything: the streaming family (a temporal DPT head carrying
# a 31-frame window), on the DA resolution menu
for _size in ("Small", "Base", "Large"):
    _register(f"Video-Depth-Anything-{_size}", _SIZE[_size.lower()],
              f"depth-anything/Video-Depth-Anything-{_size}", family="vda")
    _register(f"Metric-Video-Depth-Anything-{_size}", _SIZE[_size.lower()],
              f"depth-anything/Metric-Video-Depth-Anything-{_size}", metric=True,
              family="vda")

# Depth-Anything-3: every entry metric; NESTED pairs a ViT-G anyview branch
# with a ViT-L metric branch
for _size in ("SMALL", "BASE", "LARGE", "GIANT"):
    _register(f"DA3-{_size}", _SIZE[_size.lower()], f"depth-anything/DA3-{_size}",
              metric=True, family="da3")
_register("DA3METRIC-LARGE", "vitl", "depth-anything/DA3METRIC-LARGE", metric=True,
          family="da3")
_register("DA3MONO-LARGE", "vitl", "depth-anything/DA3MONO-LARGE", metric=True, family="da3")
_register("DA3NESTED-GIANT-LARGE", "vitg", "depth-anything/DA3NESTED-GIANT-LARGE-1.1",
          metric=True, family="da3")

# DPT-DINOv2 (KITTI / NYU): a DINOv2 trunk with the classic readout DPT
# decoder; metric, mean = std = 0.5
for _size in ("small", "base", "large", "giant"):
    for _ds in ("kitti", "nyu"):
        _register(f"dpt-dinov2-{_size}-{_ds}", _SIZE[_size], f"facebook/dpt-dinov2-{_size}-{_ds}",
                  metric=True, family="dpt_dinov2", norm_family="half")

# the classic patch-16 DPT family: plain ViT (dpt-large, and the reference
# author's retrained weights of the same architecture), the BiT + ViT hybrid
# and the BEiT trunk with a relative-position bias
_register("dpt-hybrid-midas", "vitb", "lc700x/dpt-hybrid-midas-hf", family="dpt_hybrid",
          patch_size=16, norm_family="half")
_register("dpt-large", "vitl", "Intel/dpt-large", family="dpt", patch_size=16,
          norm_family="half")
_register("dpt-large-redesign", "vitl", "lc700x/dpt-large-redesign-hf", family="dpt",
          patch_size=16, norm_family="half")
_register("dpt-beit-base-384", "vitb", "Intel/dpt-beit-base-384", family="dpt_beit",
          patch_size=16, norm_family="half")
_register("dpt-beit-large-512", "vitl", "Intel/dpt-beit-large-512", family="dpt_beit",
          patch_size=16, norm_family="half")

# ZoeDepth: a BEiT-L/16 trunk (24x24 window) with the classic DPT decoder as
# its relative head and a metric-bins head
for _ds in ("nyu-kitti", "nyu", "kitti"):
    _register(f"zoedepth-{_ds}", "vitl", f"Intel/zoedepth-{_ds}", metric=True,
              family="zoedepth", patch_size=16, norm_family="half")
# DepthPro: a square 1536 input cut into 35 tiles of one shared DINOv2-L/14
_register("DepthPro-Large", "vitl", "apple/DepthPro-hf", metric=True, family="depthpro",
          norm_family="half", resolutions=(1536,), square_only=True)
# InfiniDepth: a DINOv3 trunk (SmallPlus: 384 wide with a SwiGLU MLP) and an
# implicit head; the model normalizes RGB in [0, 1] itself
for _size, _v in (("Small", "vits"), ("SmallPlus", "vitsplus"), ("Base", "vitb"),
                  ("Large", "vitl")):
    _register(f"InfiniDepth-{_size}", _v, f"lc700x/InfiniDepth-{_size}", family="infinidepth",
              patch_size=16, norm_family="none")

_register("depth-ai", "vitl", "lc700x/depth-ai-hf", metric=True)


def da3_mode(name: str) -> str:
    """"anyview" (DualDPT + camera decoder), "mono" or "metric" (DPT + sky)
    for a DA3 registry name, as the JAX `DepthAnything3.from_spec` reads it
    (NESTED's own branch is anyview)."""
    upper = name.upper()
    if "MONO" in upper:
        return "mono"
    if "METRIC" in upper and "NESTED" not in upper:
        return "metric"
    return "anyview"


def is_da3_nested(spec: ModelSpec) -> bool:
    """DA3NESTED-GIANT-LARGE: two branches aligned, not one DepthAnything3."""
    return spec.family == "da3" and "NESTED" in spec.name.upper()


def get_spec(name: str) -> ModelSpec:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}") from None


def effective_compute_dtype(spec: ModelSpec, policy_dtype: torch.dtype,
                            quiet: bool = False) -> torch.dtype:
    """The model-quirk table applied to the device policy's dtype (JAX
    `core/registry.py:effective_compute_dtype`, reference utils.py:234-238
    FORCE_FP32_KEYWORDS): a `force_fp32` model computes in float32 whatever
    the policy's default."""
    if spec.force_fp32 and policy_dtype != torch.float32:
        if not quiet:
            print(f"[d2s] {spec.name}: forcing fp32 compute (model quirk)")
        return torch.float32
    return policy_dtype
