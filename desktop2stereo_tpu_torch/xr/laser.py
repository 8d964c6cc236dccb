"""Controller-ray hit testing + pose calibration for the XR frame server.

Port of `desktop2stereo_tpu/xr/laser.py`, copied: host numpy.

Host-side analog of the reference viewer's laser subsystem (reference
xr_viewer/laser.py:677-833): aim-ray ↔ virtual-screen intersection for the
flat quad and both cylindrical curve modes, unbounded-plane UV for edge
snapping, and the persisted per-hand calibration offsets (reference
xr_viewer/laser.py:628-676).  The rendering half (beam/hit-circle meshes,
controller GLB models) lives with whatever host GL/XR client attaches to
the frame server; the math here is what the input mapper needs.

Conventions match geometry.ScreenPose: seated space, -Z forward, the
screen quad spans [-1,1]^2 locally, u=0 left / v=0 bottom, and the curved
arc is z_local = r*(1-cos a) (cylinder axis through (0, r) in the curve
plane) with the size-invariant half angle from geometry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from desktop2stereo_tpu_torch.xr.geometry import CURVED_HALF_ANGLE_RAD, ScreenPose

# Rays longer than this never hit (reference xr_viewer/laser.py:696).
BEAM_MAX = 30.0
# Hits closer than this are behind/inside the controller (laser.py:722).
T_MIN = 0.01


@dataclass(frozen=True)
class RayHit:
    u: float   # [0,1], 0 = left edge
    v: float   # [0,1], 0 = bottom edge
    t: float   # along-ray distance (metres)


def _screen_frame(pose: ScreenPose):
    """(rotation[3,3], center[3]) of the screen surface in seated space."""
    rot = pose.rotation()[:3, :3].astype(np.float64)
    center = np.array(
        [pose.pan_x, pose.pan_y + pose.seat_height, -pose.distance],
        np.float64)
    return rot, center


def ray_plane_uv(origin: np.ndarray, direction: np.ndarray,
                 pose: ScreenPose) -> Optional[Tuple[float, float, float]]:
    """(u, v, t) where the ray meets the screen's INFINITE plane — UVs may
    fall outside [0,1] (used for edge snap, reference laser.py:769-796)."""
    rot, center = _screen_frame(pose)
    o = rot.T @ (np.asarray(origin, np.float64) - center)
    d = rot.T @ np.asarray(direction, np.float64)
    if abs(d[2]) < 1e-9:
        return None
    t = -o[2] / d[2]
    if t < T_MIN or t > BEAM_MAX:
        return None
    p = o + d * t
    u = 0.5 + p[0] / max(pose.width, 1e-6)
    v = 0.5 + p[1] / max(pose.height, 1e-6)
    return float(u), float(v), float(t)


def ray_screen_hit(origin: np.ndarray, direction: np.ndarray,
                   pose: ScreenPose, curved: bool = False,
                   curve_axis: str = "horizontal") -> Optional[RayHit]:
    """Bounded surface hit: flat quad, or cylindrical arc when curved
    (reference laser.py:677-770).  Returns None on miss."""
    if not curved:
        hit = ray_plane_uv(origin, direction, pose)
        if hit is None:
            return None
        u, v, t = hit
        if not (0.0 <= u <= 1.0 and 0.0 <= v <= 1.0):
            return None
        return RayHit(u, v, t)

    rot, center = _screen_frame(pose)
    o = rot.T @ (np.asarray(origin, np.float64) - center)
    d = rot.T @ np.asarray(direction, np.float64)
    half_w, half_h = pose.width / 2.0, pose.height / 2.0
    half_ang = min(CURVED_HALF_ANGLE_RAD, math.pi / 2)
    if curve_axis == "vertical":
        radius = half_h / max(half_ang, 1e-6)
        a = d[1] * d[1] + d[2] * d[2]
        b = 2.0 * (o[1] * d[1] + (o[2] - radius) * d[2])
        c = o[1] * o[1] + (o[2] - radius) ** 2 - radius * radius
    else:
        radius = half_w / max(half_ang, 1e-6)
        a = d[0] * d[0] + d[2] * d[2]
        b = 2.0 * (o[0] * d[0] + (o[2] - radius) * d[2])
        c = o[0] * o[0] + (o[2] - radius) ** 2 - radius * radius
    if abs(a) < 1e-12:
        return None
    disc = b * b - 4.0 * a * c
    if disc < 0.0:
        return None
    sq = math.sqrt(disc)
    for t in sorted(((-b - sq) / (2 * a), (-b + sq) / (2 * a))):
        if t < T_MIN or t > BEAM_MAX:
            continue
        p = o + d * t
        # Only the NEAR side of the cylinder (z < r) shows the screen.
        if curve_axis == "vertical":
            if abs(p[0]) > half_w + 1e-6:
                continue
            ang = math.atan2(p[1], radius - p[2])
            if abs(ang) > half_ang + 1e-6:
                continue
            u = (p[0] + half_w) / (2.0 * half_w)
            v = (ang + half_ang) / (2.0 * half_ang)
        else:
            if abs(p[1]) > half_h + 1e-6:
                continue
            ang = math.atan2(p[0], radius - p[2])
            if abs(ang) > half_ang + 1e-6:
                continue
            u = (ang + half_ang) / (2.0 * half_ang)
            v = (p[1] + half_h) / (2.0 * half_h)
        return RayHit(float(u), float(v), float(t))
    return None


@dataclass(frozen=True)
class PlaneSpec:
    """A rectangular interactive panel floating in seated space (virtual
    keyboard, overlay panels): yaw/pitch-tilted plane at pan/distance with a
    local half-extent rect (reference laser.py:797-833)."""

    pan_x: float = 0.0
    pan_y: float = -0.35
    distance: float = 0.55
    yaw: float = 0.0
    pitch: float = -0.45
    half_w: float = 0.30
    half_h: float = 0.10

    def basis(self):
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        x_ax = np.array([cy, 0.0, -sy], np.float64)
        y_ax = np.array([sy * sp, cp, cy * sp], np.float64)
        normal = np.array([sy * cp, -sp, cy * cp], np.float64)
        pos = np.array([self.pan_x, self.pan_y, -self.distance], np.float64)
        return x_ax, y_ax, normal, pos


def ray_panel_hit(origin: np.ndarray, direction: np.ndarray,
                  panel: PlaneSpec) -> Optional[Tuple[float, float, float]]:
    """(local_x, local_y, t) on the tilted panel plane, or None.  Bounds are
    NOT applied (key rects / panel rects test their own extents)."""
    x_ax, y_ax, normal, pos = panel.basis()
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    denom = float(normal @ d)
    if abs(denom) < 1e-9:
        return None
    t = float(normal @ (pos - o)) / denom
    if t < 0.05:  # panels sit close; slightly larger dead distance
        return None
    p = o + d * t - pos
    return float(p @ x_ax), float(p @ y_ax), t


@dataclass
class HandCalibration:
    """Per-hand aim-pose correction, persisted across sessions (reference
    laser.py:628-676): small yaw/pitch offsets applied to the raw aim
    direction, adjusted in calibration mode and saved to settings."""

    yaw_offset: float = 0.0
    pitch_offset: float = 0.0

    def apply(self, direction: np.ndarray) -> np.ndarray:
        d = np.asarray(direction, np.float64)
        cy, sy = math.cos(self.yaw_offset), math.sin(self.yaw_offset)
        cp, sp = math.cos(self.pitch_offset), math.sin(self.pitch_offset)
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        out = ry @ (rx @ d)
        n = np.linalg.norm(out)
        return out / n if n > 0 else out

    def nudge(self, d_yaw: float, d_pitch: float,
              limit: float = 0.35) -> "HandCalibration":
        return HandCalibration(
            yaw_offset=float(np.clip(self.yaw_offset + d_yaw, -limit, limit)),
            pitch_offset=float(np.clip(self.pitch_offset + d_pitch, -limit, limit)),
        )
