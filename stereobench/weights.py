"""Seeded weights, made on the device in the served dtype.

One normal draw in the served dtype from a `torch.Generator` on the device
fills every drawn leaf at once; each leaf is a view of a slice of it,
scaled in place by its own standard deviation (`reference.leaf_rules`),
and constant leaves are filled.  The same tensors go to the program
(through its `load_state_dict`) and, in float32, to the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from stereobench.reference import leaf_rules


DRAWN = ("normal", "halfnormal")


def draw(reference: nn.Module, init: dict, seed: int, device: torch.device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """name → tensor for every parameter of `reference` (built on any
    device, the meta device included)."""
    rules = leaf_rules(reference, init)
    total = sum(_numel(shape) for _, shape, kind, _ in rules if kind in DRAWN)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind, value in rules:
        n = _numel(shape)
        if kind in DRAWN:
            out[name] = flat[at:at + n].view(shape).mul_(value)  # a view of the one draw
            if kind == "halfnormal":
                out[name].abs_()
            at += n
        elif kind == "norm":
            w = torch.ones(shape, dtype=dtype, device=device)
            w[::int(init.get("norm_outlier_every", 1 << 62))] = value
            out[name] = w
        else:
            out[name] = torch.full(shape, value, dtype=dtype, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
