"""XR visual effects: screen glow, frost veil, ambient spill, passthrough.

Port of `desktop2stereo_tpu/xr/effects.py`: the frame-derived quantities
(border glow color, ambient spill) are torch ops on the frame's device (on
the client's card path, the warped eye's subsample before it is
downloaded); the rest is a copy, host math.

Host/compute-side analog of the reference's effects mixin (reference
xr_viewer/effects.py:26-1229, shaders xr_viewer/glsl.py:580-791): the
frame-derived quantities ride the frame's device, while the geometry
generators (glow band around the flat/curved screen) and state machines
(background color cycling, passthrough green-screen toggle, frost veil
strength → mip LOD curve) are plain host math for whatever renderer
attaches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.xr.geometry import CURVED_HALF_ANGLE_RAD, ScreenPose


# ------------------------------------------------------- frame-derived ----

def border_glow_color(rgb: torch.Tensor, band_frac: float = 0.06,
                      reduction: float = 0.55) -> torch.Tensor:
    """Mean color of the frame's border band, dimmed by `reduction` — the
    screen-glow tint (reference frame.py's GPU border-color reduction +
    effects.py glow band).  `rgb` [H,W,3] float 0..255 on any device;
    returns [3] in 0..1 on the same device."""
    H, W = rgb.shape[0], rgb.shape[1]
    bh = max(1, int(H * band_frac))
    bw = max(1, int(W * band_frac))
    top = rgb[:bh].reshape(-1, 3)
    bot = rgb[H - bh:].reshape(-1, 3)
    lef = rgb[:, :bw].reshape(-1, 3)
    rig = rgb[:, W - bw:].reshape(-1, 3)
    mean = (top.mean(0) + bot.mean(0) + lef.mean(0) + rig.mean(0)) / 4.0
    return mean / 255.0 * reduction


def ambient_spill(rgb: torch.Tensor,
                  intensity: float = 3.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Screen-content light spill: mean luminance × screen-light intensity
    (reference 'cinema bias-light', environments/README.md
    screen_light_intensity).  Returns a scalar spill and a [3] tint in 0..1,
    both tensors on `rgb`'s device."""
    mean = rgb.reshape(-1, 3).mean(0) / 255.0
    luma = mean[0] * 0.2126 + mean[1] * 0.7152 + mean[2] * 0.0722
    return luma * intensity, mean


# ----------------------------------------------------------- geometry -----

def glow_band_mesh(pose: ScreenPose, band: float = 0.12,
                   curved: bool = False, curve_axis: str = "horizontal",
                   segments: int = 48) -> np.ndarray:
    """Triangle-strip frame around the screen: inner edge on the screen
    border (alpha 1), outer edge pushed out by `band` metres (alpha 0).
    Returns [N, 6]: (x y z  u v  alpha); flat uses one strip per side,
    curved follows the arc (reference effects.py glow band, flat+curved)."""
    rot = pose.rotation()[:3, :3]
    center = np.array([pose.pan_x, pose.pan_y + pose.seat_height,
                       -pose.distance], np.float64)
    hw, hh = pose.width / 2.0, pose.height / 2.0

    def emit(local_in, local_out, u, v):
        win = rot @ local_in + center
        wout = rot @ local_out + center
        return [[*win, u, v, 1.0], [*wout, u, v, 0.0]]

    verts = []
    if not curved:
        ring = [(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh), (-hw, -hh)]
        for (x0, y0), (x1, y1) in zip(ring[:-1], ring[1:]):
            n = segments // 4 + 1
            for i in range(n):
                t = i / (n - 1)
                x, y = x0 + (x1 - x0) * t, y0 + (y1 - y0) * t
                # outward push along the rect normal direction
                ox = math.copysign(band, x) if abs(x) >= hw - 1e-9 else 0.0
                oy = math.copysign(band, y) if abs(y) >= hh - 1e-9 else 0.0
                verts += emit(np.array([x, y, 0.0]),
                              np.array([x + ox, y + oy, 0.0]),
                              (x / hw + 1) / 2, (y / hh + 1) / 2)
        return np.asarray(verts, np.float32)

    # curved: follow the cylinder arc along the curved extent; the band
    # extends past both arc ends and both straight edges
    half_ang = min(CURVED_HALF_ANGLE_RAD, math.pi / 2)
    extent = hw if curve_axis == "horizontal" else hh
    radius = extent / max(half_ang, 1e-6)
    for i in range(segments + 1):
        a = -half_ang + (2 * half_ang) * i / segments
        along = radius * math.sin(a)
        zoff = radius * (1.0 - math.cos(a))
        if curve_axis == "horizontal":
            li = np.array([along, -hh, zoff])
            lo = np.array([along, -hh - band, zoff])
        else:
            li = np.array([-hw, along, zoff])
            lo = np.array([-hw - band, along, zoff])
        verts += emit(li, lo, i / segments, 0.0)
    for i in range(segments + 1):
        a = -half_ang + (2 * half_ang) * i / segments
        along = radius * math.sin(a)
        zoff = radius * (1.0 - math.cos(a))
        if curve_axis == "horizontal":
            li = np.array([along, hh, zoff])
            lo = np.array([along, hh + band, zoff])
        else:
            li = np.array([hw, along, zoff])
            lo = np.array([hw + band, along, zoff])
        verts += emit(li, lo, i / segments, 1.0)
    return np.asarray(verts, np.float32)


# ------------------------------------------------------- state machines ---

def frost_lod(strength: float, max_lod: float = 6.0) -> float:
    """Frost-glass veil: strength ∈ [0,1] → source-texture mip LOD, with
    the reference's perceptual sqrt ramp (frosting rises fast then
    saturates; reference effects.py frost veil via mip LOD sampling)."""
    s = min(max(strength, 0.0), 1.0)
    return math.sqrt(s) * max_lod


# The reference cycles through a fixed palette on long-press (effects.py
# background color cycling).
BACKGROUND_COLORS: Tuple[Tuple[float, float, float], ...] = (
    (0.0, 0.0, 0.0),
    (0.02, 0.02, 0.03),
    (0.05, 0.05, 0.08),
    (0.10, 0.10, 0.10),
    (0.02, 0.04, 0.02),
    (0.04, 0.02, 0.02),
)


@dataclass
class BackgroundCycler:
    index: int = 0

    def advance(self) -> Tuple[float, float, float]:
        self.index = (self.index + 1) % len(BACKGROUND_COLORS)
        return self.color

    @property
    def color(self) -> Tuple[float, float, float]:
        return BACKGROUND_COLORS[self.index]


@dataclass
class PassthroughState:
    """Passthrough green-screen toggle (reference effects.py): when on, the
    environment clears to the chroma key so the runtime composites the
    real world; the screen stays opaque."""

    enabled: bool = False
    key_color: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def toggle(self) -> bool:
        self.enabled = not self.enabled
        return self.enabled

    def clear_color(self, fallback: Tuple[float, float, float]):
        return self.key_color if self.enabled else fallback


@dataclass(frozen=True)
class EffectsConfig:
    glow_enabled: bool = True
    glow_band: float = 0.12
    glow_reduction: float = 0.55
    frost_strength: float = 0.0
    spill_intensity: float = 3.5
