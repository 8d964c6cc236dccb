"""The check's control in the reference's form: the plain reference put in
the program's model stage and computed in fp8, the nearest precision below
the bfloat16 the configurations state.

Every linear layer and convolution quantizes its weight and its input to
float8 e4m3 (one scale a tensor, amax / 448) and computes from those in
float32; the rest of the reference stays float32.  The program's own
control is its int8 encoder (`harness.build_program(..., quant="int8")`).

For a stateful family the reference stands in the model stage as the
program's model does: `first(pixels)` and `step(pixels, carry)`, the carry
advanced by the family's `advance` (float32, one window a feed, which the
frame program keeps per row), each through `forward(pixels, frames,
caches)`, the program model's call, so that the harness's hooks read it
alike.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Fp8Linear(nn.Module):
    def __init__(self, m: nn.Linear) -> None:
        super().__init__()
        self.weight = nn.Parameter(fake_fp8(m.weight.float()), requires_grad=False)
        self.bias = m.bias

    def forward(self, x):
        return F.linear(fake_fp8(x), self.weight, self.bias)


class Fp8Conv(nn.Module):
    def __init__(self, m) -> None:
        super().__init__()
        self.m = m
        m.weight.data = fake_fp8(m.weight.data.float())

    def forward(self, x):
        return self.m(fake_fp8(x))


def _swap(module: nn.Module) -> None:
    for name, child in module.named_children():
        if isinstance(child, nn.Linear):
            setattr(module, name, Fp8Linear(child))
        elif isinstance(child, (nn.Conv2d, nn.ConvTranspose2d)):
            setattr(module, name, Fp8Conv(child))
        else:
            _swap(child)


class ReferenceModel(nn.Module):
    """The reference as the program's model stage: NHWC pixels → depth
    [B, H, W], in float32 from inputs of any dtype."""

    def __init__(self, ref: nn.Module) -> None:
        super().__init__()
        self.ref = ref

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.ref(pixels.permute(0, 3, 1, 2).float())


class StatefulReferenceModel(ReferenceModel):
    """A stateful reference as the program's model stage: NHWC pixels and
    the carry → (depth [B, H, W], entries)."""

    carry_per_stream = True

    def __init__(self, ref: nn.Module, advance) -> None:
        super().__init__(ref)
        self.advance = advance

    def forward(self, pixels: torch.Tensor, frames: int = 1, caches=None):
        return self.ref(pixels.permute(0, 3, 1, 2).float(), caches)

    def first(self, pixels: torch.Tensor):
        raw, entries = self(pixels, 1, None)
        return raw, self.advance(None, entries)

    def step(self, pixels: torch.Tensor, carry):
        raw, entries = self(pixels, 1, carry)
        return raw, self.advance(carry, entries)


def fp8_reference(family, cfg: dict, state: Dict[str, torch.Tensor],
                  device: torch.device) -> nn.Module:
    ref = family.build(cfg).to(device=device, dtype=torch.float32)
    ref.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    _swap(ref)
    if getattr(family, "STATEFUL", False):
        return StatefulReferenceModel(ref, family.advance).eval()
    return ReferenceModel(ref).eval()
