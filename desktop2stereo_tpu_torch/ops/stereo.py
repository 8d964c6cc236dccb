"""Stereo compositing: parallax warp, hole handling, display modes.

Port of `desktop2stereo_tpu/ops/stereo.py`.  Two quality tiers:

1. `make_sbs` ("fast"): the reference's torch compositor — disparity shift
   from depth, a horizontal bilinear resample with reflection padding per
   eye (kernel K3, `ops/kernels/warp.py`), arrangement, area squeeze for the
   Half modes, optional 16:9 padding.
2. `dibr_render` / `stereo_compose` ("high"): the reference viewer's DIBR
   shader — 3-tap depth pre-smooth, near boost, edge falloff, disocclusion
   confidence, directional push-pull inpaint and vertical blur.  Both eyes
   at once go through kernel K1 (`ops/kernels/dibr.py:dibr_pair_eyes`), one
   eye through kernel K5 (`ops/kernels/dibr_fill.py`).

Kernel dispatch is by device, as in every wrapper: a CUDA tensor launches
the kernel or raises, a CPU tensor takes the kernel's plain version.  A
screen roll (roll ≠ 0) rotates the parallax direction off the horizontal;
the kernels are horizontal-only, so that path runs in plain PyTorch on
every device, as the JAX package runs it outside any kernel.

Conventions: rgb is [H,W,3] float in [0,255]; depth is [H,W] float in [0,1]
with near≈1 / far≈0 (post-processed).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES
from desktop2stereo_tpu_torch.ops.kernels.dibr import dibr_pair_eyes
from desktop2stereo_tpu_torch.ops.kernels.dibr_fill import dibr_warp_fill_blend
from desktop2stereo_tpu_torch.ops.kernels.warp import clamp_shift, horizontal_sample
from desktop2stereo_tpu_torch.ops.resize import resize

DEPTH_STRENGTH_SBS = 0.05  # the reference compositor's disparity scale
FEATHER_WIDTH = 0.02       # per-eye edge feather band, fraction of the view


# --------------------------------------------------------------------------
# Sampling helpers
# --------------------------------------------------------------------------

def _reflect_coords(px: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect continuous pixel coords into [0, size-1] (grid_sample
    padding_mode='reflection' with align_corners=True)."""
    if size == 1:
        return torch.zeros_like(px)
    period = 2.0 * (size - 1)
    p = torch.fmod(px.abs(), period)
    return torch.where(p > (size - 1), period - p, p)


def _hsample(img: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """img [H,W,C] f32 sampled along W at px [H,W] (already in [0, W-1]):
    kernel K3 on a CUDA tensor, its plain version on the CPU."""
    return horizontal_sample(img.contiguous(), px.contiguous())


def _sample_const_offset(x: torch.Tensor, offset: float) -> torch.Tensor:
    """[H,W] sampled at j+offset (clamp-to-edge) for a static offset: a
    two-tap lerp of static column shifts."""
    i0 = math.floor(offset)
    f = offset - i0
    a = clamp_shift(x, i0, 1)
    if f == 0.0:
        return a
    return a * (1.0 - f) + clamp_shift(x, i0 + 1, 1) * f


def _is_rolled(roll: float) -> bool:
    """True unless the parallax direction (cosθ, sinθ) is ≈ (1, 0); roll≈π
    flips the direction and is rolled too."""
    return abs(math.sin(roll)) > 1e-6 or (1.0 - math.cos(roll)) > 1e-6


def _shift_2d(x: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """x ([H,W] or [H,W,C]) sampled at (j+dx, i+dy) for static fractional
    offsets (clamp-to-edge): a bilinear lerp of up to four static shifts."""
    ix, iy = math.floor(dx), math.floor(dy)
    fx, fy = dx - ix, dy - iy

    def at(jx: int, jy: int) -> torch.Tensor:
        return clamp_shift(clamp_shift(x, jx, 1), jy, 0)

    top = at(ix, iy)
    if fx:
        top = top * (1.0 - fx) + at(ix + 1, iy) * fx
    if fy:
        bot = at(ix, iy + 1)
        if fx:
            bot = bot * (1.0 - fx) + at(ix + 1, iy + 1) * fx
        top = top * (1.0 - fy) + bot * fy
    return top


def _sample_2d_bilinear(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge bilinear gather of img [H,W,C] at per-pixel (px, py)."""
    H, W = img.shape[0], img.shape[1]
    pxc = px.clamp(0.0, W - 1.0)
    pyc = py.clamp(0.0, H - 1.0)
    x0 = torch.floor(pxc)
    y0 = torch.floor(pyc)
    fx = (pxc - x0)[..., None]
    fy = (pyc - y0)[..., None]
    x0i = x0.long().clamp_(0, W - 1)
    x1i = (x0i + 1).clamp_(max=W - 1)
    y0i = y0.long().clamp_(0, H - 1)
    y1i = (y0i + 1).clamp_(max=H - 1)
    flat = img.reshape(H * W, -1)

    def g(yi, xi):
        return flat.index_select(0, (yi * W + xi).reshape(-1)).reshape(H, W, -1)

    top = g(y0i, x0i) * (1.0 - fx) + g(y0i, x1i) * fx
    bot = g(y1i, x0i) * (1.0 - fx) + g(y1i, x1i) * fx
    return top * (1.0 - fy) + bot * fy


# --------------------------------------------------------------------------
# 1. Fast quality: the reference's torch compositor
# --------------------------------------------------------------------------

def warp_eye_grid_sample(rgb: torch.Tensor, shifts: torch.Tensor, sign: float) -> torch.Tensor:
    """One eye: rgb sampled at x + sign·shifts with reflection."""
    W = shifts.shape[1]
    base = torch.arange(W, dtype=shifts.dtype, device=shifts.device)[None, :]
    px = _reflect_coords(base + sign * shifts, W)
    return _hsample(rgb, px)


def pad_to_aspect(img: torch.Tensor, target_ratio: Tuple[int, int] = (16, 9)) -> torch.Tensor:
    """Zero-pad [H,W,C] to the target aspect, centred."""
    H, W = img.shape[0], img.shape[1]
    t_w, t_h = target_ratio
    r_img, r_t = W / H, t_w / t_h
    if abs(r_img - r_t) < 1e-3:
        return img
    if r_img > r_t:
        new_h = int(round(W / r_t))
        top = (new_h - H) // 2
        return torch.nn.functional.pad(img, (0, 0, 0, 0, top, new_h - H - top))
    new_w = int(round(H * r_t))
    left = (new_w - W) // 2
    return torch.nn.functional.pad(img, (0, 0, left, new_w - W - left))


def make_sbs(rgb: torch.Tensor, depth: torch.Tensor, ipd_uv: float = 0.064,
             depth_ratio: float = 2.0, convergence: float = 0.0,
             display_mode: str = "Half-SBS", fill_16_9: bool = False) -> torch.Tensor:
    """The fast compositor: rgb [H,W,3] in [0,255], depth [H,W] in [0,1] →
    the composed frame [H',W',3] float in [0,255].  Modes other than the
    four SBS/TAB ones compose as Half-SBS, as in the JAX package."""
    H, W = depth.shape
    img = rgb.clamp(0.0, 255.0)
    shifts = -(depth - convergence) * depth_ratio * (ipd_uv * W) * DEPTH_STRENGTH_SBS
    left = warp_eye_grid_sample(img, shifts, +1.0)
    right = warp_eye_grid_sample(img, shifts, -1.0)
    if fill_16_9:
        left, right = pad_to_aspect(left), pad_to_aspect(right)
    out = torch.cat([left, right], dim=0 if display_mode in ("Half-TAB", "Full-TAB") else 1)
    if display_mode not in ("Full-SBS", "Full-TAB"):
        out = resize(out, (left.shape[0], left.shape[1]), mode="area")
    return out.clamp(0.0, 255.0)


# --------------------------------------------------------------------------
# 2. High quality: the viewer's DIBR shader
# --------------------------------------------------------------------------

def push_pull_inpaint(rgb: torch.Tensor, depth: torch.Tensor,
                      center_depth_inv: torch.Tensor, sweep_sign: float,
                      search_radius: int = 12, depth_tolerance: float = 0.012,
                      blur_radius: float = 2.5,
                      par_dir: Tuple[float, float] = (1.0, 0.0)) -> torch.Tensor:
    """Directional background inpaint for every pixel: a depth-weighted
    sweep, the plain opposite sweep where it found weight < 2, a tap joining
    while the running weight is <= 5, then a 3-tap vertical blur.  Taps read
    RAW depth; `par_dir` = (cosθ, sinθ) tilts them (vertical offset of tap i
    is i·sinθ·H/W, rounded to whole pixels)."""
    H, W, _ = rgb.shape
    cos_t, sin_t = par_dir

    def tap(img: torch.Tensor, direction: float, i: int) -> torch.Tensor:
        out = clamp_shift(img, int(round(direction * i * cos_t)), 1)
        return clamp_shift(out, int(round(direction * i * sin_t * (H / W))), 0)

    def sweep(direction: float, decay: float, use_depth_weight: bool):
        colors = torch.zeros_like(rgb)
        weights = torch.zeros_like(depth)
        for i in range(1, search_radius + 1):
            s_depth_inv = 1.0 - tap(depth, direction, i)
            is_bg = s_depth_inv > center_depth_inv + depth_tolerance
            dist_w = math.exp(-float(i) * decay)
            if use_depth_weight:
                w = dist_w * (1.0 + (s_depth_inv - center_depth_inv) * 10.0)
            else:
                w = torch.full_like(depth, dist_w)
            w = torch.where(is_bg & (weights <= 5.0), w, 0.0)
            colors = colors + tap(rgb, direction, i) * w[..., None]
            weights = weights + w
        return colors, weights

    fwd_c, fwd_w = sweep(sweep_sign, 0.15, True)
    bwd_c, bwd_w = sweep(-sweep_sign, 0.2, False)
    need_bwd = fwd_w < 2.0
    best_c = fwd_c + torch.where(need_bwd, 1.0, 0.0)[..., None] * bwd_c
    best_w = fwd_w + torch.where(need_bwd, bwd_w, 0.0)

    found = best_w > 0.01
    vert_c = best_c / best_w.clamp_min(1e-12)[..., None] * 0.5
    vert_w = torch.full_like(depth, 0.5)
    for dy in (-1, 1):
        off = int(round(dy * blur_radius))
        ok = (1.0 - clamp_shift(depth, off, 0)) > center_depth_inv + depth_tolerance * 0.5
        w = torch.where(ok, 0.25, 0.0)
        vert_c = vert_c + clamp_shift(rgb, off, 0) * w[..., None]
        vert_w = vert_w + w
    return torch.where(found[..., None], vert_c / vert_w[..., None], rgb)


def dibr_geometry(depth: torch.Tensor, eye_offset: float, depth_strength: float = 1.0,
                  convergence: float = 0.0, edge_margin: float = 0.05,
                  roll: float = 0.0):
    """The per-eye inputs of the DIBR warp, as `dibr_render` builds them from
    depth [H,W]: (centre depth inverse, warp position px, row position py
    or None at roll≈0, disocclusion confidence), each [H,W]."""
    H, W = depth.shape
    dt, dev = depth.dtype, depth.device
    cos_t, sin_t = math.cos(roll), math.sin(roll)
    rolled = _is_rolled(roll)
    par_sign = 1.0 if eye_offset > 0 else -1.0

    def sample_depth_at(offset_px: float) -> torch.Tensor:
        if rolled:
            return _shift_2d(depth, offset_px * cos_t, offset_px * sin_t)
        return _sample_const_offset(depth, offset_px)

    # 3-tap pre-smooth along the parallax direction at ±1.5 px
    d = (depth * 0.7 + sample_depth_at(-par_sign * 1.5) * 0.15
         + sample_depth_at(+par_sign * 1.5) * 0.15)
    depth_inv = -d
    depth_shaped = depth_inv * (1.0 + 0.35 * (1.0 - d))

    # parallax shift in UV with a smoothstep falloff at both borders
    u = ((torch.arange(W, dtype=dt, device=dev) + 0.5) / W)[None, :]
    e1 = (u / edge_margin).clamp(0.0, 1.0)
    e1 = e1 * e1 * (3.0 - 2.0 * e1)
    e2 = ((1.0 - u) / edge_margin).clamp(0.0, 1.0)
    e2 = e2 * e2 * (3.0 - 2.0 * e2)
    shift_uv = eye_offset * (depth_shaped + convergence) * depth_strength * (e1 * e2)
    px = torch.arange(W, dtype=dt, device=dev)[None, :] - shift_uv * cos_t * W

    # soft disocclusion confidence from the 2-tap depth jump
    jump = (sample_depth_at(-par_sign * 2.0) - sample_depth_at(+par_sign * 2.0)).abs()
    t = ((jump - 0.04) / (0.10 - 0.04)).clamp(0.0, 1.0)
    conf = t * t * (3.0 - 2.0 * t)
    oob = (px < 0.0) | (px > W - 1.0)
    py = None
    if rolled:
        py = torch.arange(H, dtype=dt, device=dev)[:, None] - shift_uv * sin_t * H
        oob = oob | (py < 0.0) | (py > H - 1.0)
    return depth_inv, px, py, torch.where(oob, 1.0, conf)


def dibr_render(rgb: torch.Tensor, depth: torch.Tensor, eye_offset: float,
                depth_strength: float = 1.0, convergence: float = 0.0,
                search_radius: int = 12, depth_tolerance: float = 0.012,
                edge_margin: float = 0.05, roll: float = 0.0) -> torch.Tensor:
    """One eye via the viewer's DIBR shader math; `eye_offset` is ±ipd/2 in
    UV units, `roll` the screen roll in radians.  At roll≈0 the warp, inpaint
    and blend are kernel K5 (its plain version on the CPU); a roll takes the
    2-D plain path."""
    H, W, _ = rgb.shape
    dt = rgb.dtype
    depth = depth.to(dt)
    depth_inv, px, py, conf = dibr_geometry(depth, eye_offset, depth_strength,
                                            convergence, edge_margin, roll)
    # the reference's sweep direction is eye-independent: both eyes inpaint
    # from the same side of a disocclusion
    sweep_sign = -1.0
    if py is None:
        f32 = torch.float32
        return dibr_warp_fill_blend(
            rgb.to(f32).contiguous(), depth.to(f32).contiguous(), conf.to(f32).contiguous(),
            px.clamp(0.0, W - 1.0).to(f32).contiguous(), sweep_sign=sweep_sign,
            search_radius=search_radius, depth_tolerance=depth_tolerance).to(dt)
    color = _sample_2d_bilinear(rgb, px, py).to(dt)
    filled = push_pull_inpaint(rgb, depth, depth_inv, sweep_sign, search_radius,
                               depth_tolerance, par_dir=(math.cos(roll), math.sin(roll)))
    return color + conf[..., None] * (filled - color)


# --------------------------------------------------------------------------
# Display-mode composition
# --------------------------------------------------------------------------

def edge_feather(eye: torch.Tensor, width: float = FEATHER_WIDTH) -> torch.Tensor:
    """Per-eye viewport edge feathering: rgb × (fadeL·fadeR·fadeT·fadeB)^0.7,
    each fade a smoothstep of the pixel-centre distance to its edge over
    `width` of the view.  pow distributes over the product, so the mask is
    the outer product of two vectors."""
    H, W = eye.shape[0], eye.shape[1]

    def smoothstep(x: torch.Tensor) -> torch.Tensor:
        t = (x / width).clamp(0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    def fade(n: int) -> torch.Tensor:
        uv = (torch.arange(n, dtype=torch.float32, device=eye.device) + 0.5) / n
        return (smoothstep(uv) * smoothstep(1.0 - uv)) ** 0.7

    mask = fade(H)[:, None] * fade(W)[None, :]
    return eye * mask[..., None].to(eye.dtype)


def compose_display(left: torch.Tensor, right: torch.Tensor,
                    display_mode: str = "Half-SBS") -> torch.Tensor:
    """Arrange the eyes [H,W,3] into the output frame."""
    H, W = left.shape[0], left.shape[1]
    if display_mode == "Mono":
        return left
    if display_mode in ("Half-SBS", "Full-SBS"):
        out = torch.cat([left, right], dim=1)
        return resize(out, (H, W), mode="area") if display_mode == "Half-SBS" else out
    if display_mode in ("Half-TAB", "Full-TAB"):
        out = torch.cat([left, right], dim=0)
        return resize(out, (H, W), mode="area") if display_mode == "Half-TAB" else out
    if display_mode == "Anaglyph":  # red-cyan
        return torch.stack([left[..., 0], right[..., 1], right[..., 2]], dim=-1)
    if display_mode == "Row-Interleaved":
        rows = (torch.arange(H, device=left.device) % 2 == 0)[:, None, None]
        return torch.where(rows, left, right)
    if display_mode == "Column-Interleaved":
        cols = (torch.arange(W, device=left.device) % 2 == 0)[None, :, None]
        return torch.where(cols, left, right)
    raise ValueError(f"unknown display mode {display_mode!r}")


_SPECTRAL_KEYS = ((0.0, 0.298, 0.651),    # blue (far)
                  (0.0, 0.5, 0.0),        # green
                  (1.0, 0.851, 0.0),      # yellow
                  (0.988, 0.0, 0.0))      # red (near)
_SPECTRAL_CENTERS = (0.125, 0.375, 0.625, 0.875)


def depth_colormap_spectral(depth: torch.Tensor) -> torch.Tensor:
    """Spectral_r-style colormap, the reference's branch-free weighted-key
    form: depth [H,W] in [0,1] → [H,W,3] in 0..255."""
    t = depth.clamp(0.0, 1.0)
    keys = torch.tensor(_SPECTRAL_KEYS, dtype=t.dtype, device=t.device)
    centers = torch.tensor(_SPECTRAL_CENTERS, dtype=t.dtype, device=t.device)
    w = (1.0 - (t[..., None] - centers).abs() * 4.0).clamp_min(0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 0.0, w / total.clamp_min(1e-12), w)
    # the weighted keys summed in order (as XLA's dot over the 4 keys rounds)
    rgb = w[..., 0:1] * keys[0]
    for k in range(1, len(_SPECTRAL_KEYS)):
        rgb = rgb + w[..., k:k + 1] * keys[k]
    return rgb * 255.0


def stereo_compose(rgb: torch.Tensor, depth: torch.Tensor, ipd: float = 0.064,
                   depth_strength: float = 1.0, convergence: float = 0.0,
                   display_mode: str = "Half-SBS", quality: str = "high",
                   feather: bool = False, fill_16_9: bool = False,
                   roll: float = 0.0) -> torch.Tensor:
    """The stereo stage: both eyes (DIBR, or the fast warp), optional per-eye
    edge feather and 16:9 padding, then the display arrangement.  rgb
    [H,W,3] and depth [H,W] → [H',W',3] float in [0,255]."""
    if display_mode not in DISPLAY_MODES:
        raise ValueError(f"unknown display mode {display_mode!r}; one of {DISPLAY_MODES}")
    if display_mode == "Depth":
        out = depth_colormap_spectral(depth.to(rgb.dtype))
        return edge_feather(out) if feather else out
    if quality != "high":
        # the reference's torch compositor has no feathering
        return make_sbs(rgb, depth, ipd, depth_strength, convergence, display_mode,
                        fill_16_9=fill_16_9)
    if _is_rolled(roll):
        left = dibr_render(rgb, depth, -ipd / 2.0, depth_strength, convergence, roll=roll)
        right = dibr_render(rgb, depth, +ipd / 2.0, depth_strength, convergence, roll=roll)
    else:
        left, right = _pair_eyes(rgb, depth, ipd, depth_strength, convergence)
    return _arrange(left, right, display_mode, feather, fill_16_9)


def _pair_eyes(rgb: torch.Tensor, depth: torch.Tensor, ipd: float, depth_strength: float,
               convergence: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both eyes in one pass of kernel K1, planar f32, feather 0 (the
    feather is edge_feather's: per-axis power, then the product): rgb
    [..., H, W, 3] and depth [..., H, W] → two [..., H, W, 3], a leading
    stream axis in one launch."""
    planar = rgb.to(torch.float32).movedim(-1, -3).contiguous()
    left, right = dibr_pair_eyes(planar, depth.to(torch.float32).contiguous(), ipd=ipd,
                                 depth_strength=depth_strength, convergence=convergence)
    return left.movedim(-3, -1), right.movedim(-3, -1)


def _arrange(left: torch.Tensor, right: torch.Tensor, display_mode: str, feather: bool,
             fill_16_9: bool) -> torch.Tensor:
    """Per-eye feather and 16:9 bars (beside each eye, not around the pair),
    then the display arrangement."""
    if feather:
        left, right = edge_feather(left), edge_feather(right)
    if fill_16_9:
        left, right = pad_to_aspect(left), pad_to_aspect(right)
    return compose_display(left, right, display_mode).clamp(0.0, 255.0)


def stereo_compose_streams(rgb: torch.Tensor, depth: torch.Tensor, ipd: float = 0.064,
                           depth_strength: float = 1.0, convergence: float = 0.0,
                           display_mode: str = "Half-SBS", quality: str = "high",
                           feather: bool = False, fill_16_9: bool = False) -> torch.Tensor:
    """`stereo_compose` over a stream axis: rgb [S,H,W,3] and depth [S,H,W]
    → [S,H',W',3], each row as `stereo_compose` makes it.  Where a row takes
    kernel K1 (high quality, every mode but Depth), all rows' eyes come from
    one K1 launch over the stream axis; the fast compositor's K3 and the
    Depth view take each row on its own."""
    if display_mode not in DISPLAY_MODES:
        raise ValueError(f"unknown display mode {display_mode!r}; one of {DISPLAY_MODES}")
    if display_mode == "Depth" or quality != "high":
        return torch.stack([stereo_compose(r, d, ipd, depth_strength, convergence,
                                           display_mode, quality, feather, fill_16_9)
                            for r, d in zip(rgb, depth)])
    left, right = _pair_eyes(rgb, depth, ipd, depth_strength, convergence)
    return torch.stack([_arrange(l_, r_, display_mode, feather, fill_16_9)
                        for l_, r_ in zip(left, right)])
