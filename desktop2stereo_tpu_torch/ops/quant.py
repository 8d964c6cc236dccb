"""Int8 encoder inference (`quant="int8"`): quantize at load, QuantLinear.

Port of `desktop2stereo_tpu/ops/quant.py`.  Symmetric, zero-point-free:

- weights: per-output-channel scales, quantized once at load
  (`quantize_state_dict`), stored int8 [F, K] as `nn.Linear` stores its
  weight;
- activations: dynamic per-row (per-token) abs-max scales, computed on every
  call inside the K4 kernel (`ops/kernels/quant_matmul.py`, which also
  holds `dynamic_quantize_rows`, re-exported here).

Only the encoder's dense products go int8; the patch embedding, the
LayerNorms, attention and the DPT decoder stay in the compute dtype.  The
TPU dispatch devices (`probe`, `FORCE_KERNEL`, `supported`) are not carried
over: `quant_dense` takes CPU tensors to its plain version and CUDA tensors
to the kernel.  `tp_quant_dense` is the tensor-parallel product of a
sharded encoder (`parallel/sharding.py`): K4 on this rank's slice, with the
collectives the JAX `shard_map` path (`ops/quant.py:129, 152` there) leaves
to `psum`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from desktop2stereo_tpu_torch.ops.kernels.quant_matmul import (  # noqa: F401
    K_ALIGN, activation_scale, dynamic_quantize_rows, epilogue, quant_dense, quantize_with)

# Dense module names the encoder quantizes (the JAX package's whole set, so
# that later families need no change here)
QUANT_DENSE_NAMES = frozenset(
    {"qkv", "proj", "fc1", "fc2", "weights_in", "weights_out",
     "w12", "w3",           # DA3 ViT-G SwiGLU naming
     "w1", "w2",            # InfiniDepth DINOv3 SwiGLU naming
     "query", "key", "value"})  # BEiT separate-QKV naming


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[F, K] float weight → (int8 [F, K], [F] f32 scales), scale =
    max(absmax, 1e-8) / 127 per output row.  The division runs in f64 and
    rounds once to f32, which is the IEEE f32 quotient on any device (the
    JAX package quantizes eagerly, where XLA divides)."""
    w = weight.float()
    absmax = w.abs().amax(dim=1).clamp_min(1e-8)
    scale = (absmax.double() / 127.0).float()
    return quantize_with(w, scale[:, None]), scale


def dynamic_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float activations → (int8, scalar f32 scale), per-tensor abs-max."""
    xf = x.float()
    scale = activation_scale(xf.abs().amax())
    return quantize_with(xf, scale), scale


class QuantLinear(nn.Module):
    """Drop-in for nn.Linear with an int8×int8→int32 product (K4).

    Buffers: `weight_q` [F, K] int8, `scale` [F] f32, `bias` [F] f32 (or
    None).  They come from a float state dict through `quantize_state_dict`.
    `scale` and `bias` stay f32 through `Module.to(dtype)`: the epilogue
    runs in f32, as the JAX kernel's does."""

    _F32_BUFFERS = ("scale", "bias")

    def __init__(self, in_features: int, out_features: int, bias: bool = True) -> None:
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def _apply(self, fn, recurse=True):
        # move the f32 buffers to weight_q's new device only: fn may also cast
        # floating tensors (`.to(dtype)`, `.half()`), which would round them
        kept = {n: self._buffers[n] for n in self._F32_BUFFERS if self._buffers[n] is not None}
        for n in kept:
            self._buffers[n] = None
        super()._apply(fn, recurse)
        for n, t in kept.items():
            self._buffers[n] = t.to(self.weight_q.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_dense(x, self.weight_q, self.scale, self.bias)


def quantize_state_dict(state: Dict[str, torch.Tensor],
                        scope: Union[str, Sequence[str]] = "backbone") -> Dict[str, torch.Tensor]:
    """The counterpart of the JAX `quantize_tree` on a port state dict: every
    2-D `<module>.weight` whose module name is in QUANT_DENSE_NAMES and which
    lies beneath a module named in `scope` becomes `<module>.weight_q` (int8)
    and `<module>.scale` (f32), its bias f32.  Everything else (the patch
    embedding, the neck and head, even where a name repeats) passes as is."""
    scopes = (scope,) if isinstance(scope, str) else tuple(scope)
    targets = set()
    for key, t in state.items():
        parts = key.split(".")
        if (parts[-1] == "weight" and t.ndim == 2 and len(parts) >= 3
                and parts[-2] in QUANT_DENSE_NAMES and any(p in scopes for p in parts[:-2])):
            targets.add(".".join(parts[:-1]))
    out: Dict[str, torch.Tensor] = {}
    for key, t in state.items():
        module, _, name = key.rpartition(".")
        if module not in targets:
            out[key] = t
        elif name == "weight":
            out[f"{module}.weight_q"], out[f"{module}.scale"] = quantize_weight(t.cpu())
        else:
            out[key] = t.float()
    return out


def tp_quant_fits(k: int) -> bool:
    """Whether K4 takes a product over k inputs (k a multiple of K_ALIGN):
    where a rank's slice of a row-parallel layer does not fit, the layer
    and its column-parallel partner stay whole (`parallel/sharding.py`)."""
    return k > 0 and k % K_ALIGN == 0


def tp_quant_dense(ctx, x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor], role: str,
                   scatter_tokens: bool = False) -> Optional[torch.Tensor]:
    """The int8 product of a Megatron-sharded layer on this rank, or None
    (declined) where the product K4 would see does not fit `tp_quant_fits`.

    - role "col" (replaces the JAX shard_map at `ops/quant.py:129`): x is the
      whole input [..., K], weight_q / scale / bias this rank's feature
      slice; one K4 launch gives those features, bit-equal to the same
      columns of the whole product (the row scales span the whole K either
      way).  No collective.
    - role "row" (replaces the shard_map at `ops/quant.py:152`): x is this
      rank's slice of the inputs [..., K/tp], weight_q its [F, K/tp] slice,
      scale and bias whole.  The activation scale must span the whole K:
      the local row abs-max is all-reduced (MAX) over the model group, then
      K4 runs in int32 mode with that `row_scale`, the accumulators are
      all-reduced (SUM, exact and order-free) and the f32 epilogue runs
      once, as `quant_dense_ref` runs it: bit-equal to one unsharded K4
      launch.  With `scatter_tokens` (sequence parallelism) the sum is a
      reduce-scatter over the N tokens of x (dim -2, padded to a multiple
      of tp) and this rank's [..., ceil(N/tp), F] block comes back.
    """
    if role not in ("col", "row"):
        raise ValueError(f"tp_quant_dense: role 'col' or 'row', not {role!r}")
    K = x.shape[-1]
    if not tp_quant_fits(K):
        return None
    if role == "col":
        return quant_dense(x, weight_q, scale, bias)
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    ctx.model_all_reduce(absmax, "max")
    sx = activation_scale(absmax)
    acc = quant_dense(x, weight_q, scale, row_scale=sx, out_dtype=torch.int32)
    if scatter_tokens:
        n = x.shape[-2]
        acc, sx = ctx.reduce_scatter_tokens(acc, n), ctx.own_tokens(sx, n)
    else:
        ctx.model_all_reduce(acc, "sum")
    F = weight_q.shape[0]
    lead = acc.shape[:-1]
    return epilogue(acc.reshape(-1, F), sx.reshape(-1, 1), scale, bias,
                    x.dtype).reshape(*lead, F)
