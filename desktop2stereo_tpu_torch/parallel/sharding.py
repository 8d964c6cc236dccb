"""Multi-GPU execution: data-parallel frame batches and a tensor-parallel ViT.

Port of `desktop2stereo_tpu/parallel/sharding.py`.  The JAX package lays a
("data", "model") mesh over its devices and lets GSPMD insert the
collectives from sharding annotations.  Here the mesh is a grid of
processes over `torch.distributed` (`core/runtime.py:make_mesh`, one rank a
shard; `parallel/launch.py:spawn` starts them) and the layout is the
computation: every sharded layer holds only its own slice of the weights
and does its own collectives.

- The data axis splits a batch of frames (`parallel_frame_apply`): each
  data index runs its B/dp rows through a whole model (or a tensor-parallel
  one) and keeps its rows of the output.
- The model axis splits each encoder layer Megatron-style: the first
  product of the attention and of the MLP is column-parallel (each rank
  computes its slice of the output features, no collective), the second is
  row-parallel (each rank multiplies its slice of the inputs and the
  partial products are summed over the model group).  Each rank runs K2 on
  its local heads and K4 on its local slice of every int8 product.

The port's layouts, which differ from the JAX package's contiguous split
(`_tp_spec_for` shards a fused [D, 3D] qkv kernel in two halves of its
output axis, so that rank 0 holds all of q and half of k, and GSPMD repairs
that with collectives):

- a fused `qkv` [3D, D] is split by heads: rank r holds rows
  [r·D/tp, (r+1)·D/tp) of each of the q, k and v thirds, in that order, so
  its [3D/tp, D] product splits into q, k and v of its own H/tp heads;
- a paired SwiGLU product (`weights_in`, DA3's `w12`) [2h, D] is split
  pair by pair: rank r holds the same hidden indices [r·h/tp, (r+1)·h/tp)
  of x1 and of x2, so `silu(x1)·x2` pairs its columns as the whole layer
  does;
- any other column-parallel product (`query`, `key`, `value`, `fc1`,
  InfiniDepth's `w1`/`w2`) is split in tp contiguous row blocks, its bias
  and int8 scale alongside; a row-parallel product (`proj`, `fc2`,
  `weights_out`, `w3`) in tp contiguous column blocks [F, K/tp], its bias
  and scale whole;
- BEiT's relative-position table [(2W-1)²+3, H] is split by head columns,
  so the layer's interpolated [H/tp, R] table holds the rows of its heads.

A float row-parallel product sums its bf16 partial products in f32 over the
model group, adds the bias once after the sum and casts back; an int8 one
goes through `ops/quant.py:tp_quant_dense` (full-K activation scale, exact
int32 sum, one epilogue).  The units are split whole or not at all: an
attention whose head count does not divide tp, an MLP whose hidden width
does not, or an int8 unit whose row-parallel slice K4 cannot take, stays
whole on every rank, with no collective (the divisibility guard of the
JAX `shard_params`).

Sequence parallelism (the JAX `token_constraint`, DINOv2 trunks only): the
residual stream between the layers holds ceil(N/tp) tokens a rank (N padded
with zeros to a multiple of tp); LayerNorm, LayerScale and the residual adds
run on them; the normed tokens are all-gathered and trimmed to N before the
products that mix tokens, and each row-parallel product reduce-scatters
its partial sums back to the local tokens; the neck receives the first N
tokens of each tapped layer, gathered.

The JAX context variable is not needed: a sharded model carries its
context in its layers, nothing global changes, and an unsharded model in
the same process runs as it always does.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from desktop2stereo_tpu_torch.core.runtime import Mesh
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, tp_quant_dense, tp_quant_fits


@dataclass(frozen=True)
class ParallelContext:
    """This rank's mesh and the collectives the sharded layers use.

    `sequence_parallel` is `parallel_frame_apply`'s default.  Every
    collective runs over the model group (the data group for `gather`), on
    the tensors' own device: NCCL takes CUDA tensors, gloo CPU and CUDA
    ones (torch 2.11's gloo takes each of these collectives on CUDA
    tensors and moves them through host memory itself)."""

    mesh: Mesh
    sequence_parallel: bool = False

    @property
    def dp(self) -> int:
        return self.mesh.num_data

    @property
    def tp(self) -> int:
        return self.mesh.num_model

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def data_index(self) -> int:
        return self.mesh.data_index

    @property
    def model_index(self) -> int:
        return self.mesh.model_index

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def backend(self) -> str:
        return self.mesh.backend

    # -- collectives ------------------------------------------------------------

    def model_all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or "max") `t` over the model group, in place."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, op=red, group=self.mesh.model_group)
        return t

    def _padded(self, n: int) -> int:
        return -(-n // self.tp) * self.tp

    def own_tokens(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """[..., n, D] → this rank's ceil(n/tp) tokens (dim -2), zero-padded
        to a multiple of tp first."""
        x = F.pad(x, (0, 0, 0, self._padded(n) - n))
        local = self._padded(n) // self.tp
        return x.narrow(-2, self.model_index * local, local).contiguous()

    def gather_tokens(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's ceil(n/tp) tokens [..., n/tp, D] → all n, [..., n, D]."""
        t = x.movedim(-2, 0).contiguous()
        out = t.new_empty((self.tp * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.mesh.model_group)
        return out[:n].movedim(0, -2).contiguous()

    def reduce_scatter_tokens(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Partial sums [..., n, F] → this rank's ceil(n/tp) tokens of their
        sum over the model group (n zero-padded to a multiple of tp)."""
        t = F.pad(x, (0, 0, 0, self._padded(n) - n)).movedim(-2, 0).contiguous()
        out = t.new_empty((t.shape[0] // self.tp, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=self.mesh.model_group)
        return out.movedim(0, -2).contiguous()

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """The data-sharded output blocks [B/dp, ...] of every data index →
        the whole batch [B, ...], in data order (for a caller that needs
        it; `parallel_frame_apply` keeps its block)."""
        if self.dp == 1:
            return out
        t = out.contiguous()
        whole = t.new_empty((self.dp * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(whole, t, group=self.mesh.data_group)
        return whole


# ViT-trunk scopes across every family (DA/DA3/VDA/BEiT/ZoeDepth/InfiniDepth
# use "backbone"; DepthPro's two towers are patch_encoder / image_encoder).
# The rules apply only INSIDE these scopes: decoder and head products reuse
# names like proj/fc1 between whole neighbours, where sharding one product
# would buy a per-frame gather for nothing.  A model whose ViT layers sit at
# its top level (dpt-large, dpt-hybrid: "layer") names them in `tp_scopes`.
ENCODER_SCOPES = frozenset({"backbone", "patch_encoder", "image_encoder"})


def megatron_role(parent: str) -> Optional[str]:
    """Megatron role of an ENCODER product by its module name, across every
    family: column-parallel (shard output features) for qkv/q/k/v and the
    first MLP product (DA fc1/weights_in, DA3 w12, InfiniDepth w1/w2,
    BEiT query/key/value + fc1), row-parallel (shard input features) for
    proj and the second MLP product.  Anything else stays whole.  The JAX
    `_parent_role`, verbatim."""
    if parent in ("w1", "w2"):
        return "col"
    if parent.startswith(("qkv", "query", "key", "value", "fc1",
                          "weights_in", "w12")):
        return "col"
    # "proj" must be EXACT: VDA's temporal proj_in/proj_out are module
    # entry/exit projections whose neighbours are whole
    if parent == "proj" or parent == "w3" \
            or parent.startswith(("fc2", "weights_out")):
        return "row"
    return None


def tp_spec_for(key: str, shape: Sequence[int],
                scopes: Iterable[str] = ENCODER_SCOPES) -> Optional[int]:
    """The dim a state-dict entry shards on, or None (whole): on a torch
    [out, in] weight (`weight`, `weight_q`), dim 0 for a column-parallel
    product and dim 1 for a row-parallel one; on a column-parallel product's
    1-D bias or scale, dim 0.  Only inside a scope.  The JAX `_tp_spec_for`
    on the transposed [in, out] kernel."""
    names = key.split(".")
    if len(names) < 2 or not set(names[:-2]) & set(scopes):
        return None
    role = megatron_role(names[-2])
    if role == "col":
        return 0 if len(shape) in (1, 2) else None
    if role == "row" and len(shape) == 2:
        return 1
    return None


_ATTENTION = frozenset({"qkv", "query", "key", "value", "proj"})
_PAIRED = frozenset({"weights_in", "w12"})   # [x1; x2] halves, chunked in forward
_TABLE = "relative_position_bias.relative_position_bias_table"   # BEiT, [R, H]


@dataclass(frozen=True)
class Unit:
    """One Megatron pair of an encoder layer: the products of `owner`'s
    attention ("attention") or MLP ("mlp"), by module name, and whether it
    splits over the model axis (see `plan`)."""

    owner: str
    kind: str
    col: Tuple[str, ...]
    row: Tuple[str, ...]
    split: bool


def head_counts(model: nn.Module) -> Dict[str, int]:
    """{module path: heads} of every module that owns an attention's
    products (num_heads and a qkv / query child)."""
    return {name: m.num_heads for name, m in model.named_modules()
            if hasattr(m, "num_heads") and any(
                hasattr(m, c) for c in ("qkv", "query"))}


def plan(state: Mapping[str, torch.Tensor], tp: int, heads: Mapping[str, int],
         scopes: Iterable[str] = ENCODER_SCOPES) -> Dict[Tuple[str, str], Unit]:
    """The units of a state dict and whether each splits over tp ranks.

    An attention splits when its head count (`heads[owner]`) divides tp;
    an MLP when its hidden width (the row-parallel product's inputs) does.
    An int8 unit splits only where K4 takes each product it would launch
    (`tp_quant_fits`: K/tp of a row-parallel slice, where the JAX package
    declines at K/tp % 128, and the whole K of a column-parallel one).
    A unit without both a column- and a row-parallel product stays whole."""
    scopes = frozenset(scopes)
    found: Dict[Tuple[str, str], Dict[str, list]] = {}
    for key, t in state.items():
        names = key.split(".")
        if names[-1] not in ("weight", "weight_q") or t.ndim != 2 or len(names) < 3:
            continue
        if tp_spec_for(key, t.shape, scopes) is None:
            continue
        owner, parent = ".".join(names[:-2]), names[-2]
        unit = found.setdefault((owner, "attention" if parent in _ATTENTION else "mlp"),
                                {"col": [], "row": [], "widths": [], "int8_k": []})
        if megatron_role(parent) == "row":
            unit["row"].append(parent)
            unit["widths"].append(t.shape[1])
            if names[-1] == "weight_q":  # the K one rank's K4 launch sees
                unit["int8_k"].append(t.shape[1] // tp)
        else:
            unit["col"].append(parent)
            unit["widths"].append(
                t.shape[0] // (3 if parent == "qkv" else 2 if parent in _PAIRED else 1))
            if names[-1] == "weight_q":
                unit["int8_k"].append(t.shape[1])
    units = {}
    for (owner, kind), u in found.items():
        split = (tp > 1 and bool(u["col"]) and bool(u["row"])
                 and all(w % tp == 0 for w in u["widths"])
                 and all(tp_quant_fits(k) for k in u["int8_k"]))
        if kind == "attention":
            split = split and owner in heads and heads[owner] % tp == 0
        units[(owner, kind)] = Unit(owner, kind, tuple(u["col"]), tuple(u["row"]), split)
    return units


def _block(t: torch.Tensor, dim: int, r: int, tp: int, groups: int = 1) -> torch.Tensor:
    """Rank r's block of `t` on `dim`, taken from each of `groups` equal
    consecutive parts (3 for a fused qkv, 2 for a SwiGLU pair)."""
    size = t.shape[dim] // groups
    step = size // tp
    parts = [t.narrow(dim, g * size + r * step, step) for g in range(groups)]
    # a copy, never a view: the shard must not keep the whole tensor alive
    return torch.cat(parts, dim=dim) if groups > 1 else parts[0].clone()


def shard_params(state: Mapping[str, torch.Tensor], ctx: ParallelContext,
                 heads: Mapping[str, int],
                 scopes: Iterable[str] = ENCODER_SCOPES) -> Dict[str, torch.Tensor]:
    """A whole port state dict → this rank's shard of it, in the layouts of
    the module docstring.  `heads` maps each attention's module path to its
    head count (`head_counts(model)`).  The counterpart of the JAX
    `shard_params`, after `from_flax` of the JAX tree (or of any checkpoint)."""
    units = plan(state, ctx.tp, heads, scopes)
    r, tp = ctx.model_index, ctx.tp
    out: Dict[str, torch.Tensor] = {}
    for key, t in state.items():
        names = key.split(".")
        owner, parent = ".".join(names[:-2]), names[-2] if len(names) > 1 else ""
        unit = units.get((owner, "attention" if parent in _ATTENTION else "mlp"))
        dim = tp_spec_for(key, t.shape, scopes)
        if key.endswith("." + _TABLE):
            att = units.get((key[: -len(_TABLE) - 1], "attention"))
            out[key] = _block(t, 1, r, tp) if att is not None and att.split else t
        elif unit is None or not unit.split or dim is None:
            out[key] = t
        else:
            groups = 3 if parent == "qkv" and dim == 0 else (
                2 if parent in _PAIRED and dim == 0 else 1)
            out[key] = _block(t, dim, r, tp, groups)
    return out


class ColumnParallelLinear(nn.Linear):
    """nn.Linear over this rank's slice of the output features (the whole
    input in, no collective); the JAX package's GSPMD-sharded Dense."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 ctx: ParallelContext) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.tp_ctx = ctx


class RowParallelLinear(nn.Linear):
    """nn.Linear over this rank's slice of the input features: the partial
    product (bf16 on the card) is summed over the model group in f32, the
    bias added once after the sum, then cast back to x's dtype.  With
    `scatter` (sequence parallelism) the sum is a reduce-scatter that leaves
    this rank's tokens.  Replaces GSPMD's all-reduce after the JAX package's
    row-sharded Dense."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 ctx: ParallelContext) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.tp_ctx = ctx
        self.scatter = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        part = F.linear(x, self.weight).float()
        if self.scatter:
            part = self.tp_ctx.reduce_scatter_tokens(part, x.shape[-2])
        else:
            self.tp_ctx.model_all_reduce(part, "sum")
        if self.bias is not None:
            part = part + self.bias.float()
        return part.to(x.dtype)


class ColumnParallelQuantLinear(QuantLinear):
    """QuantLinear over this rank's slice of the output features
    (`tp_quant_dense` "col": one K4 launch, no collective)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 ctx: ParallelContext) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.tp_ctx = ctx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_quant_dense(self.tp_ctx, x, self.weight_q, self.scale, self.bias, "col")


class RowParallelQuantLinear(QuantLinear):
    """QuantLinear over this rank's slice of the input features
    (`tp_quant_dense` "row": full-K scale, K4 in int32 mode, exact sum)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 ctx: ParallelContext) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.tp_ctx = ctx
        self.scatter = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_quant_dense(self.tp_ctx, x, self.weight_q, self.scale, self.bias, "row",
                              scatter_tokens=self.scatter)


ROW_PARALLEL = (RowParallelLinear, RowParallelQuantLinear)


def shard_model(model: nn.Module, ctx: ParallelContext,
                scopes: Optional[Iterable[str]] = None) -> nn.Module:
    """Turn a whole model into this rank's shard, in place, and move it to
    `ctx.device`; → the model.

    Each role-carrying nn.Linear or QuantLinear of a unit that splits
    (`plan`) becomes its column- or row-parallel form over this rank's
    slice (`shard_params` of the model's own state dict); the attention
    that owns it takes its local head count, and a BEiT layer its table's
    head columns.  Units that do not split, and everything outside the
    encoder scopes (ENCODER_SCOPES and the model's `tp_scopes`), stay as
    they are.  Build the whole model on the CPU to keep it off the card."""
    scopes = frozenset(scopes if scopes is not None else
                       ENCODER_SCOPES | frozenset(getattr(model, "tp_scopes", ())))
    heads = head_counts(model)
    state = model.state_dict()
    units = plan(state, ctx.tp, heads, scopes)
    shard = shard_params(state, ctx, heads, scopes)
    del state
    for unit in units.values():
        if not unit.split:
            continue
        owner = model.get_submodule(unit.owner)
        for name, row in [(c, False) for c in unit.col] + [(r, True) for r in unit.row]:
            old = getattr(owner, name)
            quant = isinstance(old, QuantLinear)
            if quant:
                f_out, f_in = old.weight_q.shape
                cls = RowParallelQuantLinear if row else ColumnParallelQuantLinear
            else:
                f_out, f_in = old.out_features, old.in_features
                cls = RowParallelLinear if row else ColumnParallelLinear
            has_bias = old.bias is not None
            if row:
                f_in //= ctx.tp
            else:
                f_out //= ctx.tp
            with torch.device("meta"):
                setattr(owner, name, cls(f_in, f_out, has_bias, ctx))
        if unit.kind == "attention":
            owner.num_heads //= ctx.tp
            table = f"{unit.owner}.{_TABLE}"
            if table in shard:
                holder = model.get_submodule(table.rpartition(".")[0])
                holder.relative_position_bias_table = nn.Parameter(
                    torch.empty(shard[table].shape, device="meta"))
    model.load_state_dict(shard, strict=True, assign=True)
    return model.to(ctx.device)


@contextmanager
def _sequence_parallel(model: nn.Module, ctx: ParallelContext, on: bool):
    """Sequence parallelism on the DINOv2 trunks of `model` (modules with a
    `sequence_parallel` attribute) for the duration of one call: the trunk
    keeps ceil(N/tp) tokens a rank and its row-parallel layers
    reduce-scatter.  Restored afterwards, whatever happens."""
    trunks = [m for m in model.modules() if hasattr(m, "sequence_parallel")] if on else []
    rows = [m for t in trunks for m in t.modules() if isinstance(m, ROW_PARALLEL)]
    for t in trunks:
        t.sequence_parallel = ctx
    for m in rows:
        m.scatter = True
    try:
        yield
    finally:
        for t in trunks:
            t.sequence_parallel = None
        for m in rows:
            m.scatter = False


def parallel_frame_apply(model: nn.Module, ctx: ParallelContext,
                         sequence_parallel: Optional[bool] = None) -> Callable:
    """Wraps `model(pixels, ...)` for a data-sharded frame batch: the
    returned function takes the whole batch pixels [B, H, W, 3] on every
    rank (any device), runs this data index's B/dp rows on `ctx.device`
    through the (sharded) model and returns this rank's block of the
    output, as the JAX output stays data-sharded; `ctx.gather` makes the
    whole batch.  B % dp != 0 raises ValueError.

    `sequence_parallel` (default `ctx.sequence_parallel`) also shards each
    DINOv2 trunk's residual stream on the token dim over the model axis (see
    the module docstring); it has no effect at tp = 1 or on other trunks,
    as the JAX `token_constraint` has none outside `models/dinov2.py`."""
    sp = ctx.sequence_parallel if sequence_parallel is None else sequence_parallel

    def run(pixels: torch.Tensor, *args, **kwargs):
        B = pixels.shape[0]
        if B % ctx.dp:
            raise ValueError(f"parallel_frame_apply: batch {B} does not split over "
                             f"{ctx.dp} data ranks")
        b = B // ctx.dp
        local = pixels[ctx.data_index * b:(ctx.data_index + 1) * b].to(ctx.device)
        with _sequence_parallel(model, ctx, sp and ctx.tp > 1):
            return model(local, *args, **kwargs)

    return run
