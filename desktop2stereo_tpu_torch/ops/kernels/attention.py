"""Attention kernel (csrc/attention.cu) and its plain version.

Replaces `desktop2stereo_tpu/ops/pallas/flash_attention.py:flash_attention`.
Layout [B, N, H, hd] as in the JAX package, hd = 64 with a contiguous head
dim; q/k/v are read through their strides (the views of a fused qkv
projection need no copy), and the result is a fresh contiguous [B, N, H, 64]
in q's dtype.  The kernel has two bodies, chosen by q's dtype:

- bf16 q/k/v: TMA + wgmma (16-byte aligned rows, no zero stride: a TMA
  tensor map takes none), f32 logits and softmax, bf16 probabilities;
- f32 q/k/v (`--fp32`, the converter's gate): SIMT FMA on the CUDA cores in
  true f32, no TF32 and no wgmma (16-byte aligned pointers and strides in
  multiples of 4 elements, since rows are read as float4; a zero stride is
  fine, as there is no tensor map), its own three `*_f32_fwd` entries.

There is no cast between the two: an f32 call on CUDA runs the f32 body or
raises, and any other dtype raises.  An additive bias, shared by the batch
and added to the scaled logits before the softmax, takes one of two entry
points of either body:

- `attention(q, k, v, bias)`: a dense contiguous [H, N, N] bias in bf16 or
  f32 (`d2s_attention_bias_fwd`, the counterpart of the JAX package's
  `multi_head_attention(..., bias=)`);
- `attention_relpos(q, k, v, table, gh, gw)`: BEiT's relative-position bias
  as one layer's table, transposed to a contiguous [H, R] in bf16 or f32,
  R = (2gh-1)(2gw-1) + 3, for an N = gh·gw + 1 token grid
  (`d2s_attention_relpos_fwd`).  The kernel gathers B[h, i, j] =
  table[h, idx(i, j)] itself from shared memory, through the closed form of
  HF's index map (see csrc/attention.cu), so no [H, N, N] tensor is built
  or read.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary

HEAD_DIM = 64

BIAS_DTYPES = (torch.bfloat16, torch.float32)

# The table entry's dynamic shared memory (csrc/attention.cu relpos_smem):
# the block's Q tile, two K/V stages and its barriers, then the head's table
# row in f32 and an int offset for every key of the visited tiles; one block
# may take at most 227 KB.
_BQ, _BKV, _STAGES = 64, 128, 2
RELPOS_SMEM_BASE = 1024 + _BQ * HEAD_DIM * 2 + 2 * _STAGES * _BKV * HEAD_DIM * 2 + 48
SMEM_MAX = 232448
# The f32 body's (csrc/attention.cu relpos_smem_f32): two stages of a 64-key
# K and V tile in f32, then the table row and every key's offset.
_F_KT = 64
RELPOS_F32_SMEM_BASE = 2 * 2 * _F_KT * HEAD_DIM * 4

QKV_DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_QKV = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float]
KERNEL = CudaLibrary("attention.cu", {
    "d2s_attention_fwd": _QKV + [_P],
    "d2s_attention_bias_fwd": _QKV + [_P, _I, _P],
    "d2s_attention_relpos_fwd": _QKV + [_P, _I, _I, _I, _I, _P],
    "d2s_attention_f32_fwd": _QKV + [_P],
    "d2s_attention_bias_f32_fwd": _QKV + [_P, _I, _P],
    "d2s_attention_relpos_f32_fwd": _QKV + [_P, _I, _I, _I, _I, _P],
    "d2s_attention_info": [_I, _I, _I, _I, _P],
})

ENTRIES = {"attention": 0, "attention_bias": 1, "attention_relpos": 2,
           "attention_f32": 3, "attention_bias_f32": 4, "attention_relpos_f32": 5}


# ---- BEiT's relative-position index ------------------------------------------------------

def relative_position_count(gh: int, gw: int) -> int:
    """R, the entries of a gh × gw grid's table: (2gh-1)(2gw-1) + 3."""
    return (2 * gh - 1) * (2 * gw - 1) + 3


def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[(wh·ww+1)²] flat index map into the bias table (HF modeling_beit.py
    generate_relative_position_index)."""
    num_rel = relative_position_count(wh, ww)
    yy, xx = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    coords = np.stack([yy.reshape(-1), xx.reshape(-1)])  # [2, N]
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    area = wh * ww
    index = np.zeros((area + 1, area + 1), dtype=np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, :] = num_rel - 3
    index[:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index.reshape(-1)


@functools.lru_cache(maxsize=8)
def _index_on(gh: int, gw: int, device: torch.device) -> torch.Tensor:
    """The index map as a tensor on `device`, built once per grid (every
    layer gathers with it).  Made outside inference mode, so that a map
    first built under `torch.inference_mode` also serves callers outside
    it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_relative_position_index(gh, gw)).to(device)


def expand_rel_pos(table: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """[H, R] table → the dense contiguous [H, N, N] bias, N = gh·gw + 1, in
    the table's dtype (an exact gather through the index map)."""
    n = gh * gw + 1
    return table[:, _index_on(gh, gw, table.device)].reshape(table.shape[0], n, n)


def relpos_smem_bytes(n: int, r: int, f32: bool = False) -> int:
    """The table entry's dynamic shared memory for N tokens and R entries,
    of the bf16 body or (`f32`) the f32 one."""
    if f32:
        return RELPOS_F32_SMEM_BASE + -(-r // 4) * 16 + -(-n // _F_KT) * _F_KT * 4
    return RELPOS_SMEM_BASE + -(-r // 4) * 16 + -(-n // _BKV) * _BKV * 4


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax(QKᵀ/√hd + bias)·V over materialised f32 logits; the
    counterpart of `desktop2stereo_tpu/ops/attention.py:xla_attention`
    (`bias` [H, N, N] added in f32 to the scaled logits; probabilities are
    cast to q's dtype before the P·V product, output in q's dtype)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()[None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v.to(q.dtype))


def attention_relpos_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         table: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Plain version of the table entry: the [H, R] table expanded to the
    dense [H, N, N] bias through the index map, then `attention_ref`; the
    counterpart of the JAX package's `build_rel_pos_bias` followed by
    `xla_attention(..., bias)`."""
    return attention_ref(q, k, v, expand_rel_pos(table, gh, gw))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 rel_pos: Optional[Tuple[torch.Tensor, int, int]] = None) -> None:
    """Raise ValueError for anything the kernel does not take; `rel_pos` is
    the table entry's (table, gh, gw)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention kernel needs equal [B,N,H,hd] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"attention kernel needs head dim {HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    B, N, H, _ = q.shape
    if q.dtype not in QKV_DTYPES or {k.dtype, v.dtype} != {q.dtype}:
        raise ValueError(f"attention kernel needs bf16 or f32 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    f32 = q.dtype == torch.float32
    # 16-byte aligned rows: the bf16 body's TMA boxes and the f32 body's
    # float4 loads; only a TMA tensor map refuses a zero stride
    per_row = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        sb, sn, sh, sd = t.stride()
        if sd != 1:
            raise ValueError(f"attention kernel needs a contiguous head dim "
                             f"for {name}, strides {t.stride()}")
        if (sb | sn | sh) % per_row or t.data_ptr() % 16:
            raise ValueError(f"attention kernel needs 16-byte aligned rows for "
                             f"{name}: strides {t.stride()}, ptr {t.data_ptr()}")
        if not f32 and ((sb == 0 < B - 1) or (sn == 0 < N - 1) or (sh == 0 < H - 1)):
            raise ValueError(f"attention kernel needs distinct rows for {name} (a TMA "
                             f"tensor map takes no zero stride): strides {t.stride()}")
    if q.shape[1] == 0 or q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"attention kernel: unsupported shape {tuple(q.shape)}")
    if bias is not None:
        if tuple(bias.shape) != (H, N, N):
            raise ValueError(f"attention kernel needs a [H, N, N] = {[H, N, N]} bias, got "
                             f"{tuple(bias.shape)}")
        if bias.dtype not in BIAS_DTYPES:
            raise ValueError(f"attention kernel needs a bf16 or f32 bias, got {bias.dtype}")
        if not bias.is_contiguous() or bias.data_ptr() % 16:
            raise ValueError(f"attention kernel needs a contiguous, 16-byte aligned bias: "
                             f"strides {bias.stride()}, ptr {bias.data_ptr()}")
    if rel_pos is not None:
        table, gh, gw = rel_pos
        if gh < 1 or gw < 1 or N != gh * gw + 1:
            raise ValueError(f"attention kernel needs N = gh·gw + 1 tokens for a {gh}x{gw} "
                             f"grid, got N = {N}")
        R = relative_position_count(gh, gw)
        if tuple(table.shape) != (H, R):
            raise ValueError(f"attention kernel needs a [H, R] = {[H, R]} table for a "
                             f"{gh}x{gw} grid, got {tuple(table.shape)}")
        if table.dtype not in BIAS_DTYPES:
            raise ValueError(f"attention kernel needs a bf16 or f32 table, got {table.dtype}")
        if not table.is_contiguous() or table.data_ptr() % 16:
            raise ValueError(f"attention kernel needs a contiguous, 16-byte aligned table: "
                             f"strides {table.stride()}, ptr {table.data_ptr()}")
        if relpos_smem_bytes(N, R, f32) > SMEM_MAX:
            raise ValueError(f"attention kernel: a {gh}x{gw} grid's table ({R} entries) and "
                             f"key offsets take {relpos_smem_bytes(N, R, f32)} bytes of shared "
                             f"memory, over the {SMEM_MAX}-byte budget of one block")


def _launch(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *extra) -> torch.Tensor:
    """A fresh [B, N, H, 64] output, and `entry` launched into it on q's
    current stream with the q/k/v pointers and strides, then `extra`."""
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.call(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(D),
                *extra, stream)
    return out


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True for all-CPU tensors, False for one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: q/k/v (and bias or table) must share one CUDA device (or "
                         f"all be on the CPU), got {sorted(map(str, devices))}")
    return False


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B,N,H,hd] (+ bias [H,N,N]) → [B,N,H,hd].  CPU tensors take
    `attention_ref`; CUDA tensors take the kernel's body for q's dtype (bf16
    or f32) or raise."""
    if _on_cpu("attention", *((q, k, v) if bias is None else (q, k, v, bias))):
        return attention_ref(q, k, v, bias)
    check_inputs(q, k, v, bias)
    f32 = "_f32" if q.dtype == torch.float32 else ""
    if bias is None:
        return _launch(f"d2s_attention{f32}_fwd", q, k, v)
    return _launch(f"d2s_attention_bias{f32}_fwd", q, k, v, bias.data_ptr(),
                   int(bias.dtype == torch.float32))


def attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                     gh: int, gw: int) -> torch.Tensor:
    """[B,N,H,hd] with BEiT's relative-position bias from `table` [H, R] for
    a gh × gw grid (N = gh·gw + 1) → [B,N,H,hd].  CPU tensors take
    `attention_relpos_ref`; CUDA tensors take the kernel's table entry or
    raise."""
    if _on_cpu("attention_relpos", q, k, v, table):
        return attention_relpos_ref(q, k, v, table, gh, gw)
    check_inputs(q, k, v, rel_pos=(table, gh, gw))
    f32 = "_f32" if q.dtype == torch.float32 else ""
    return _launch(f"d2s_attention_relpos{f32}_fwd", q, k, v, table.data_ptr(),
                   int(table.dtype == torch.float32), table.shape[1], gh, gw)


def kernel_info(entry: str, f32: bool = False, n: int = 0, r: int = 0) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory and
    resident blocks an SM of one kernel instance (`entry` one of ENTRIES,
    the `*_f32` ones the f32 body's; `f32` the bias's or table's dtype), at
    n tokens and r table entries.
    Needs the card: it builds and loads the library."""
    out = (ctypes.c_int * 4)()
    code = KERNEL.lib.d2s_attention_info(ENTRIES[entry], int(f32), n, r, out)
    if code != 0:
        raise RuntimeError(f"attention.cu:d2s_attention_info failed: cudaError {code} "
                           f"({KERNEL.lib.d2s_error_string(code).decode()})")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))
