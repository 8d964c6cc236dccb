"""JAX (flax) parameter tree → state_dict of the port's modules.

The port names its modules after the flax tree, so the mapping is
mechanical:

- a subtree `name_<i>` (flax's `layer_3`, `reassemble_0`, `conv_1`,
  `fusion_2`) becomes `name.<i>` (an nn.ModuleList entry, or an
  nn.ModuleDict's where the indices do not start at 0), unless a sibling is
  called `name` itself (VDA's temporal module holds `norm`, a GroupNorm,
  beside `norm_0` and `norm_1`): then it keeps its name; a leaf keeps its
  name (BEiT's `lambda_1` and `lambda_2` parameters);
- Dense kernels [in, out] become Linear weights [out, in];
- Conv kernels HWIO become Conv2d weights OIHW;
- the conv-transpose kernels of a reassemble stage (the DPT neck's, the
  classic DPT decoder's, the VDA head's, and the DA3 heads'
  `reassemble.resize_{0,1}`, whichever branch holds them) and DepthPro's
  (the upsample blocks' ConvTs after their 1x1 projection, the image
  block's, the fusion layers' `deconv` and the head's `head_deconv`) are
  stored (C, O, f, f) on both sides and are kept as they are;
- LayerNorm `scale` becomes `weight`; every other leaf keeps its name;
- a quantized Dense (`kernel_q` [in, out] int8, `scale`, `bias`; see the JAX
  `ops/quant.py:quantize_tree`) becomes a QuantLinear: `weight_q` [out, in]
  int8, `scale` and `bias` f32.

Every leaf but `kernel_q` arrives as float32.  Arrays are numpy (or anything
`np.asarray` takes), so this module needs no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from desktop2stereo_tpu_torch.models.dpt import REASSEMBLE_FACTORS

_INDEXED = re.compile(r"^(.*)_(\d+)$")
# path endings of the (C, O, f, f) conv-transpose kernels
_CONV_TRANSPOSE = tuple(end for i, f in enumerate(REASSEMBLE_FACTORS) if f > 1
                        for end in (f"neck.reassemble.{i}.resize.kernel",
                                    f"decoder.reassemble.{i}.resize.kernel",
                                    f"head.reassemble.{i}.resize.kernel",
                                    f"head.reassemble.resize.{i}.kernel"))
_DEPTHPRO_CONV_TRANSPOSE = re.compile(
    r"(^|\.)(head_deconv|deconv|image_block\.layers\.\d+"
    r"|(scaled|intermediate)\.\d+\.layers\.[1-9]\d*)\.kernel$")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        m = _INDEXED.match(k) if isinstance(v, Mapping) else None
        name = f"{m.group(1)}.{m.group(2)}" if m and m.group(1) not in tree else k
        path = f"{prefix}.{name}" if prefix else name
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (with or without the top-level "params" key) → state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = _flatten(params)
    quantized = {path.rpartition(".")[0] for path in flat if path.endswith(".kernel_q")}
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in flat.items():
        head, _, name = path.rpartition(".")
        if name == "kernel_q":                     # int8 [in, out] → [out, in]
            state[f"{head}.weight_q"] = torch.from_numpy(
                np.ascontiguousarray(np.array(leaf, dtype=np.int8).T))
            continue
        a = np.array(leaf, dtype=np.float32)  # a writable copy
        if name == "kernel":
            if path.endswith(_CONV_TRANSPOSE) or _DEPTHPRO_CONV_TRANSPOSE.search(path):
                pass                               # (C, O, f, f) on both sides
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)        # HWIO → OIHW
            elif a.ndim == 2:
                a = a.T                            # [in, out] → [out, in]
            else:
                raise ValueError(f"unexpected kernel rank at {path}: {a.shape}")
            name = "weight"
        elif name == "scale" and head not in quantized:
            name = "weight"
        key = f"{head}.{name}" if head else name
        state[key] = torch.from_numpy(np.ascontiguousarray(a))
    return state
