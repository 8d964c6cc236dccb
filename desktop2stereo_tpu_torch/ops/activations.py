"""GELU with the JAX package's dtype split (`desktop2stereo_tpu/ops/activations.py`).

bf16/f16 take the tanh form, f32 keeps exact erf — the same split, so bf16
outputs track the reference and f32 parity runs stay exact-GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_APPROX_DTYPES = (torch.bfloat16, torch.float16)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if x.dtype in _APPROX_DTYPES else "none")
