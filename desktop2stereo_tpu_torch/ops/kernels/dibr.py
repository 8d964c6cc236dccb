"""Both-eyes DIBR kernel (csrc/dibr_pair.cu) and its plain version.

Replaces `desktop2stereo_tpu/ops/pallas/dibr.py:dibr_render_pair_planar` in
its two uses: the flagship tail's (`out_mode="eyes_u8"`, then an XLA concat
and transpose), where `dibr_pair_half` writes the finished Half-SBS
[eh, 2·ew, 3] or Half-TAB [2·eh, ew, 3] u8 frame; and the generic stereo
tail's (`out_mode="eyes"`), where `dibr_pair_eyes` writes both eyes as planar
f32 [3, h, w] at the full frame width.  Inputs are planar rgb [3, h, w] f32
(0..255) and depth [h, w] f32 in [0, 1].  No edge padding: clamp-to-edge
reads on the true frame equal the JAX kernel's reads of its edge-padded
frame.  Both entry points launch the same kernel and count on one `KERNEL`.

Both also take a stream axis, as `jax.vmap` over the JAX program's tail
gives the TPU kernel a batch grid axis: rgb [S, 3, h, w] with depth
[S, h, w] is one launch over S frames (the batched multi-stream program),
each row's output bit-equal to a one-frame launch on that row; the plain
versions loop over the rows.

The launch geometry of both DIBR kernels (this one and K5,
`dibr_fill.py`) is computed here, in `tile_geometry`, and checked by the C
side: a block owns a segment of one row and stages it once in shared memory
with a halo of the sweep radius each side, and each thread computes `PIX`
consecutive pixels (csrc/dibr_tile.cuh).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary
from desktop2stereo_tpu_torch.ops.kernels.warp import clamp_shift

SEARCH_RADIUS = 12
DEPTH_TOLERANCE = 0.012
EDGE_MARGIN = 0.05
VSHIFT = 2
ARRANGEMENTS = ("sbs", "tab")

# csrc/dibr_tile.cuh: pixels a thread, threads a block, shared bytes a block
PIX = 4
MAX_THREADS = 256
MAX_SMEM = 232448
# pixels a block aims at (tile_geometry).  K1 stages a whole row instead
# where its tile takes at most WHOLE_ROW_SMEM bytes (a 4K eye's 1920 columns,
# 46.6 KB), so that its warp gathers read shared memory too: at 1920 columns
# whole rows ran 7% faster than 512-pixel segments, at 3840 (93 KB, two
# blocks an SM) 18% slower (PERF.md)
SEG_TARGET = 512
WHOLE_ROW_SMEM = 48 * 1024


class TileGeometry(NamedTuple):
    """The launch geometry the C entry points take after their own
    arguments, in this order."""
    seg: int      # pixels a block owns, a multiple of PIX
    halo: int     # staged columns each side, a multiple of 4 (at least 4)
    pix: int      # consecutive pixels a thread
    threads: int  # threads a block
    smem: int     # dynamic shared-memory bytes a block
    grid_x: int   # blocks a row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_smem_bytes(seg: int, halo: int) -> int:
    """float4 {r, g, b, 1-d} slots (one pad slot every four columns) plus the
    raw depth row, for seg + 2·halo staged columns."""
    cols = seg + 2 * halo
    return 16 * (cols + cols // 4) + 4 * cols


def tile_geometry(width: int, radius: int, seg_target: int,
                  whole_row_smem: int = 0) -> TileGeometry:
    """Blocks of about `seg_target` pixels (0: the whole row), or the whole
    row where its tile takes at most `whole_row_smem` bytes; balanced over
    the row and split further until a block's tile fits in shared memory; a
    thread a PIX-pixel group, at most MAX_THREADS a block (a thread takes
    several groups in turn).  A block that holds the whole row gathers its
    warp taps from shared memory."""
    halo = max(4, _cdiv(radius, 4) * 4)
    whole = not seg_target or tile_smem_bytes(_cdiv(width, PIX) * PIX, halo) <= whole_row_smem
    blocks = 1 if whole else _cdiv(width, seg_target)
    while True:
        seg = _cdiv(_cdiv(width, blocks), PIX) * PIX
        smem = tile_smem_bytes(seg, halo)
        if smem <= MAX_SMEM:
            break
        blocks += 1
    return TileGeometry(seg=seg, halo=halo, pix=PIX, threads=min(seg // PIX, MAX_THREADS),
                        smem=smem, grid_x=_cdiv(width, seg))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOMETRY = [_I] * len(TileGeometry._fields)
KERNEL = CudaLibrary(
    "dibr_pair.cu",
    {"d2s_dibr_pair_half": [_P, _P, _P, _I, _I, _I, _F, _F, _F, ctypes.c_double,
                            _I, *_GEOMETRY, _P],
     "d2s_dibr_pair_eyes": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, *_GEOMETRY, _P]},
    # no contracted multiply-adds: keeps the kernel within rounding of the
    # plain version, whose every op rounds on its own
    extra_flags=("-fmad=false",),
)


def _smoothstep(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to f32 (f32 operands; the f64 product is exact).

    The JAX kernel's warp position is sensitive to one ulp: a px that
    rounds differently moves `frac`, and the bilinear warp turns that into
    up to ~4e-3 of a 0..255 value.  XLA contracts the multiply-adds that
    lead to it (centre smooth, depth shaping plus convergence, warp
    position) into fused ones, so the plain version and the CUDA kernel
    round those once as well."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return float(np.float32(x))
    return (f64(a) * f64(b) + f64(c)).float()


def _edge_coords(idx: torch.Tensor, n: int, scale: float):
    """(u·scale, (1-u)·scale) for u = (idx+0.5)/n, rounded as XLA compiles
    the JAX kernel: 1/n and `scale` fold into one f32 constant, and 1-u is a
    fused multiply-add."""
    c = idx + 0.5
    r = np.float32(1.0 / n)
    s = np.float32(scale)
    return c * float(r * s), _fma(-c, r, 1.0) * float(s)


def dibr_pair_eyes_ref(rgb_h: torch.Tensor, dep_h: torch.Tensor, *, ipd: float,
                       depth_strength: float, convergence: float,
                       feather: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, up to quantisation: (left, right) planar f32 [3, eh, ew].

    Per pixel: a 3-tap centre depth smooth and depth shaping, a smoothstep
    edge falloff, the disocclusion confidence from the ±2 px depth jump, a
    forward (depth-weighted) and a backward (plain) push-pull sweep over RAW
    depth, ±2-row vertical taps, then per eye a bilinear warp at the
    depth-driven position and the confidence blend; optional edge feather.
    With a stream axis (rgb [S, 3, eh, ew], depth [S, eh, ew]) each row on
    its own, → [S, 3, eh, ew] each.
    """
    if rgb_h.ndim == 4:
        eyes = [dibr_pair_eyes_ref(r, d, ipd=ipd, depth_strength=depth_strength,
                                   convergence=convergence, feather=feather)
                for r, d in zip(rgb_h, dep_h)]
        return torch.stack([e[0] for e in eyes]), torch.stack([e[1] for e in eyes])
    rgb, d = rgb_h, dep_h
    H, W = d.shape
    h_lo = clamp_shift(d, -2, -1) * 0.5 + clamp_shift(d, -1, -1) * 0.5  # tap at -1.5 px
    h_hi = clamp_shift(d, 1, -1) * 0.5 + clamp_shift(d, 2, -1) * 0.5    # tap at +1.5 px
    smooth = _fma(h_hi, 0.15, _fma(d, 0.7, h_lo * 0.15))
    cdi = -smooth
    jump = (clamp_shift(d, -2, -1) - clamp_shift(d, 2, -1)).abs()
    conf_base = _smoothstep(((jump - 0.04) / (0.10 - 0.04)).clamp(0.0, 1.0))
    # shaped depth (-s)·(1 + 0.35·(1 - s)), plus the convergence offset
    shaped_conv = _fma(-smooth, _fma(0.35, 1.0 - smooth, 1.0), convergence)

    col = torch.arange(W, dtype=torch.float32, device=d.device).expand(H, W)
    lo, hi = _edge_coords(col, W, np.float32(1.0) / np.float32(EDGE_MARGIN))
    e1 = _smoothstep(lo.clamp(0.0, 1.0))  # smoothstep edge falloff,
    e2 = _smoothstep(hi.clamp(0.0, 1.0))  # EDGE_MARGIN of the width
    shift_base = shaped_conv * (depth_strength * (e1 * e2))  # XLA's association

    # inpaint sweeps: neighbour taps read RAW depth, only cdi is smoothed
    inv_raw = 1.0 - d
    thr = cdi + DEPTH_TOLERANCE
    pre_w = 1.0 - 10.0 * cdi

    def sweep(direction: int, depth_weighted: bool, decay: float):
        acc = torch.zeros_like(rgb)
        wsum = torch.zeros_like(d)
        for t in range(1, SEARCH_RADIUS + 1):
            off = direction * t
            s_inv = clamp_shift(inv_raw, off, -1)
            dist = math.exp(-float(t) * decay)
            if depth_weighted:
                w = dist * pre_w + (10.0 * dist) * s_inv
            else:
                w = torch.full_like(d, dist)
            w = torch.where((s_inv > thr) & (wsum <= 5.0), w, 0.0)
            acc = acc + clamp_shift(rgb, off, -1) * w
            wsum = wsum + w
        return acc, wsum

    fwd_c, fwd_w = sweep(-1, True, 0.15)
    bwd_c, bwd_w = sweep(+1, False, 0.2)

    vadd = torch.zeros_like(rgb)
    vert_w = torch.full_like(d, 0.5)
    for off in (-VSHIFT, VSHIFT):
        w = torch.where((1.0 - clamp_shift(d, off, -2)) > cdi + DEPTH_TOLERANCE * 0.5,
                        0.25, 0.0)
        vadd = vadd + clamp_shift(rgb, off, -2) * w
        vert_w = vert_w + w
    inv_vw = 1.0 / vert_w

    need_bwd = fwd_w < 2.0
    best_w = fwd_w + torch.where(need_bwd, bwd_w, 0.0)
    found = best_w > 0.01
    scale = 0.5 / best_w.clamp_min(1e-12)
    best_c = fwd_c + torch.where(need_bwd, bwd_c, 0.0)
    filled = torch.where(found, (best_c * scale + vadd) * inv_vw, rgb)

    if feather > 0.0:
        # (fade_l·fade_r·fade_t·fade_b)^0.7, smoothstep fades over `feather`
        row = torch.arange(H, dtype=torch.float32, device=d.device)[:, None].expand(H, W)
        fu, fu1 = _edge_coords(col, W, 1.0 / feather)
        fv, fv1 = _edge_coords(row, H, 1.0 / feather)
        fmask = (_smoothstep(fu.clamp(0.0, 1.0)) * _smoothstep(fu1.clamp(0.0, 1.0))
                 * _smoothstep(fv.clamp(0.0, 1.0))
                 * _smoothstep(fv1.clamp(0.0, 1.0))) ** 0.7

    eyes = []
    for eye in (-abs(ipd / 2.0), abs(ipd / 2.0)):
        # px = col - eye·shift·W, with eye·W folded to one f32 constant
        disp = float(np.float32(eye) * np.float32(W))
        px = _fma(shift_base, -disp, col)
        oob = (px < 0.0) | (px > W - 1.0)
        pxc = px.clamp(0.0, W - 1.0)
        i0f = torch.floor(pxc)
        frac = pxc - i0f
        i0 = i0f.long()
        i1 = (i0 + 1).clamp_(max=W - 1)
        g0 = torch.gather(rgb, 2, i0.expand(3, H, W))
        g1 = torch.gather(rgb, 2, i1.expand(3, H, W))
        color = g0 * (1.0 - frac) + g1 * frac
        conf = torch.where(oob, 1.0, conf_base)
        out = color + conf * (filled - color)
        if feather > 0.0:
            out = out * fmask
        eyes.append(out)
    return eyes[0], eyes[1]


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """clip(x + 0.5, 0, 255) truncated to u8 (the kernels' rounding)."""
    return (x + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def dibr_pair_half_ref(rgb_h: torch.Tensor, dep_h: torch.Tensor, *, ipd: float,
                       depth_strength: float, convergence: float,
                       feather: float = 0.0, arrangement: str = "sbs") -> torch.Tensor:
    """Plain version of `dibr_pair_half`: the finished u8 HWC frame, or
    [S, ...] frames for a stream axis (each row on its own)."""
    kw = dict(ipd=ipd, depth_strength=depth_strength, convergence=convergence,
              feather=feather, arrangement=arrangement)
    if rgb_h.ndim == 4:
        return torch.stack([dibr_pair_half_ref(r, d, **kw) for r, d in zip(rgb_h, dep_h)])
    left, right = dibr_pair_eyes_ref(
        rgb_h, dep_h, ipd=ipd, depth_strength=depth_strength,
        convergence=convergence, feather=feather)
    axis = 2 if arrangement == "sbs" else 1
    both = torch.cat([quantize_u8(left), quantize_u8(right)], dim=axis)
    return both.permute(1, 2, 0).contiguous()


def check_inputs(rgb_h: torch.Tensor, dep_h: torch.Tensor, arrangement: str = "sbs") -> None:
    """Raise ValueError for anything the kernel does not take: rgb [3,eh,ew]
    with depth [eh,ew], or a stream axis, rgb [S,3,eh,ew] with depth
    [S,eh,ew]."""
    if arrangement not in ARRANGEMENTS:
        raise ValueError(f"arrangement must be one of {ARRANGEMENTS}, got {arrangement!r}")
    if (rgb_h.ndim not in (3, 4) or rgb_h.shape[-3] != 3
            or dep_h.shape != rgb_h.shape[:-3] + rgb_h.shape[-2:]):
        raise ValueError(f"dibr kernel needs rgb [3,eh,ew] and depth [eh,ew], or [S,3,eh,ew] "
                         f"and [S,eh,ew], got {tuple(rgb_h.shape)} and {tuple(dep_h.shape)}")
    for name, t in (("rgb", rgb_h), ("depth", dep_h)):
        if t.dtype != torch.float32:
            raise ValueError(f"dibr kernel needs f32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dibr kernel needs a contiguous {name}")
    eh, ew = dep_h.shape[-2:]
    if eh == 0 or ew == 0 or eh > 65535:
        raise ValueError(f"dibr kernel: unsupported eye size {eh}x{ew}")
    if rgb_h.ndim == 4 and not 1 <= rgb_h.shape[0] <= 65535:
        raise ValueError(f"dibr kernel: unsupported stream count {rgb_h.shape[0]}")


def _on_cpu(rgb_h: torch.Tensor, dep_h: torch.Tensor) -> bool:
    """True for CPU inputs (the plain version); False for one CUDA device."""
    if rgb_h.device.type == "cpu" and dep_h.device.type == "cpu":
        return True
    if rgb_h.device != dep_h.device or rgb_h.device.type != "cuda":
        raise ValueError(f"dibr: rgb and depth must share one CUDA device (or "
                         f"both be on the CPU), got {rgb_h.device}, {dep_h.device}")
    return False


def _streams(rgb: torch.Tensor) -> int:
    """Frames in one launch: the stream axis's length, else 1."""
    return rgb.shape[0] if rgb.ndim == 4 else 1


def dibr_pair_eyes(rgb: torch.Tensor, dep: torch.Tensor, *, ipd: float,
                   depth_strength: float,
                   convergence: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both eyes, unfeathered → (left, right) planar f32 [3, h, w], or
    [S, 3, h, w] each for a stream axis.  CPU tensors take
    `dibr_pair_eyes_ref` (row by row); CUDA tensors take the kernel, one
    launch for all rows, or raise."""
    check_inputs(rgb, dep)
    kw = dict(ipd=ipd, depth_strength=depth_strength, convergence=convergence)
    if _on_cpu(rgb, dep):
        return dibr_pair_eyes_ref(rgb, dep, **kw)
    h, w = dep.shape[-2:]
    left = torch.empty_like(rgb)
    right = torch.empty_like(rgb)
    stream = torch.cuda.current_stream(rgb.device).cuda_stream
    KERNEL.call("d2s_dibr_pair_eyes", rgb.data_ptr(), dep.data_ptr(),
                left.data_ptr(), right.data_ptr(), _streams(rgb), h, w, float(ipd),
                float(depth_strength), float(convergence),
                *tile_geometry(w, SEARCH_RADIUS, SEG_TARGET, WHOLE_ROW_SMEM), stream)
    return left, right


def dibr_pair_half(rgb_h: torch.Tensor, dep_h: torch.Tensor, *, ipd: float,
                   depth_strength: float, convergence: float,
                   feather: float = 0.0, arrangement: str = "sbs") -> torch.Tensor:
    """Both eyes → u8 [eh, 2·ew, 3] ("sbs") or [2·eh, ew, 3] ("tab"), or
    [S, ...] frames for a stream axis.  CPU tensors take `dibr_pair_half_ref`
    (row by row); CUDA tensors take the kernel, one launch for all rows, or
    raise."""
    check_inputs(rgb_h, dep_h, arrangement)
    if _on_cpu(rgb_h, dep_h):
        return dibr_pair_half_ref(rgb_h, dep_h, ipd=ipd, depth_strength=depth_strength,
                                  convergence=convergence, feather=feather,
                                  arrangement=arrangement)
    eh, ew = dep_h.shape[-2:]
    tab = arrangement == "tab"
    shape = dep_h.shape[:-2] + ((2 * eh, ew, 3) if tab else (eh, 2 * ew, 3))
    out = torch.empty(shape, dtype=torch.uint8, device=rgb_h.device)
    stream = torch.cuda.current_stream(rgb_h.device).cuda_stream
    KERNEL.call("d2s_dibr_pair_half", rgb_h.data_ptr(), dep_h.data_ptr(),
                out.data_ptr(), _streams(rgb_h), eh, ew, float(ipd), float(depth_strength),
                float(convergence), float(feather), int(tab),
                *tile_geometry(ew, SEARCH_RADIUS, SEG_TARGET, WHOLE_ROW_SMEM), stream)
    return out
