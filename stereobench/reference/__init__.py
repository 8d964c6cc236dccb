"""Plain float32 references of the benchmark's model families and of the
frame path around them.

Each family module (`depth_anything.py`, `depthpro.py`) exposes the same
functions, which the harness finds by the family name a configuration
file gives:

- `build(cfg)` → an `nn.Module` whose parameter names and shapes are the
  program's state-dict names, so that one seeded state dict loads into
  both; `forward(pixels)` takes normalized NCHW pixels, → raw depth
  [B, H, W];
- `model_input_size(cfg, oh, ow)` → the model input's size for an output
  size, and `RESIZE_MODE`, the capture → model input resize.

`leaf_rules` says how the seeded weights draw each parameter.  Nothing
here imports the program, JAX or the JAX package.
"""

from typing import List, Tuple

import torch.nn as nn


def leaf_rules(module: nn.Module, init: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, value) of every parameter: kind "normal" draws
    N(0, value²), "const" fills `value`, "norm" fills 1 but every
    `init["norm_outlier_every"]`-th channel, which is `value`.  Kernels
    (linear, convolution, patch embedding) are lecun-normal over their
    fan-in (a transposed convolution's fan-in is its input channels);
    LayerNorms' weights are 1 with a few outlier channels of
    `init["norm_outlier"]` (as trained ViTs have; default none);
    LayerScale is `init["layer_scale"]`; the cls token and the position
    table draw N(0, token_std²) and every bias N(0, bias_std²).  A kernel
    named in `init["positive"]` draws |N(0, σ²)| ("halfnormal": a depth head
    whose output is positive, as a trained one's is), and a leaf named in
    `init["fixed"]` is that constant."""
    transposed = {f"{n}.weight" for n, m in module.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    norms = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, nn.LayerNorm)}
    fixed = init.get("fixed", {})
    positive = set(init.get("positive", ()))
    rules = []
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name in fixed:
            rule = ("const", float(fixed[name]))
        elif "layer_scale" in leaf:
            rule = ("const", float(init["layer_scale"]))
        elif name in norms:
            rule = ("norm", float(init.get("norm_outlier", 1.0)))
        elif leaf in ("cls_token", "position_embeddings"):
            rule = ("normal", float(init["token_std"]))
        elif leaf == "bias":
            rule = ("normal", float(init["bias_std"]))
        else:
            fan_in = shape[0] if name in transposed else p[0].numel()
            rule = ("halfnormal" if name in positive else "normal", fan_in ** -0.5)
        rules.append((name, shape, *rule))
    return rules
