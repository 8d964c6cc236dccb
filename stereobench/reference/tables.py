"""The bfloat16 yardstick's second arithmetic: resizes and transposed
convolutions computed the way a bfloat16 program folds them.

A bfloat16 program may run a bilinear resize as two products with
[out, in] weight tables held in bfloat16 (rows, then columns, each pass
rounded), and a 1x1 projection followed by k=s=2 transposed convolutions
as one composed kernel, itself rounded to bfloat16.  Both are exact in
real arithmetic and round differently from the plain layers.  Inside
`folded()`, `interpolate` and the reference modules that call
`folded_active()` compute so; outside it everything is plain.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_state = threading.local()


@contextlib.contextmanager
def folded():
    prev = getattr(_state, "on", False)
    _state.on = True
    try:
        yield
    finally:
        _state.on = prev


def folded_active() -> bool:
    return getattr(_state, "on", False)


def bilinear_weights(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """[n_out, n_in] float64: row i holds the two taps of output i, as
    `F.interpolate(mode="bilinear")` places them (source coordinates below
    0 clamp to 0, the last tap to n_in - 1)."""
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        if align_corners:
            src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        else:
            src = max((i + 0.5) * n_in / n_out - 0.5, 0.0)
        i0 = min(int(np.floor(src)), n_in - 1)
        i1 = min(i0 + 1, n_in - 1)
        frac = src - i0
        w[i, i0] += 1.0 - frac
        w[i, i1] += frac
    return w


def interpolate(x: torch.Tensor, size: Sequence[int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW `x` to `size`: `F.interpolate`, or inside
    `folded()` the two table products in x's dtype."""
    size = (int(size[0]), int(size[1]))
    if not folded_active():
        return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)
    h, w = x.shape[-2:]
    if (h, w) == size:
        return x
    wh = torch.from_numpy(bilinear_weights(h, size[0], align_corners)).to(x.device, x.dtype)
    ww = torch.from_numpy(bilinear_weights(w, size[1], align_corners)).to(x.device, x.dtype)
    y = torch.matmul(wh, x)                      # rows: [.., out_h, w]
    return torch.matmul(y, ww.t())               # columns


def compose(kernel: torch.Tensor, bias: Optional[torch.Tensor], deconv: torch.Tensor,
            deconv_bias: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An expansion kernel [C, O, P, P] (a transposed convolution's layout,
    stride P) followed by a k=s=2 transposed convolution (O, Y, 2, 2) → one
    kernel [C, Y, 2P, 2P], computed in the kernels' dtype; the bias [O, P, P]
    (or None) → [Y, 2P, 2P]."""
    C, _, P, _ = kernel.shape
    Y = deconv.shape[1]
    k2 = torch.einsum("copq,oygk->cypgqk", kernel, deconv).reshape(C, Y, 2 * P, 2 * P)
    b2 = None
    if bias is not None:
        b2 = torch.einsum("opq,oygk->ypgqk", bias, deconv).reshape(Y, 2 * P, 2 * P)
    if deconv_bias is not None:
        db = deconv_bias.view(Y, 1, 1).expand(Y, 2 * P, 2 * P)
        b2 = db if b2 is None else b2 + db
    return k2, b2


def expand(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The stride-P transposed convolution of `kernel` [C, Y, P, P], then
    its bias: [Y] per channel, or [Y, P, P] per position in each P x P
    block."""
    P = kernel.shape[-1]
    y = F.conv_transpose2d(x, kernel.to(x.dtype), stride=P)
    if bias is None:
        return y
    if bias.ndim == 1:
        return y + bias.to(x.dtype).view(1, -1, 1, 1)
    reps = (1, y.shape[-2] // P, y.shape[-1] // P)
    return y + bias.to(x.dtype).repeat(*reps)[None]
