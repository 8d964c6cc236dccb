"""Virtual screen geometry for XR presentation.

Port of `desktop2stereo_tpu/xr/geometry.py`, copied: host numpy.

Flat and cylindrically curved screen meshes plus the world model matrix
from the user's pose controls, matching the reference XR viewer's screen
semantics (reference xr_viewer/screen.py:28-175): a fixed angular span for
the curve so wider screens get a larger radius, yaw-pitch-roll rotation
order, pan/distance translation, and named size/distance presets.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

# Fixed cylindrical half-angle: all curved screens share the same arc span.
CURVED_HALF_ANGLE_RAD = math.radians(30.0)

# (name, width_m, distance_m) — the reference's preset table shape
# (reference xr_viewer/screen.py:522-560).
SCREEN_PRESETS = (
    ("Cinema", 8.0, 6.0),
    ("Living room", 4.0, 3.0),
    ("Desk", 2.2, 1.5),
    ("Tablet", 1.0, 0.8),
)


def _rotation_ypr(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """4x4 rotation, yaw (Y) · pitch (X) · roll (Z) applied to the quad."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = (ry @ rx @ rz).astype(np.float32)
    return out


@dataclass(frozen=True)
class ScreenPose:
    """Pose + size of the virtual screen in world (seated) space.

    The screen quad spans [-1,1]² locally; `model_matrix` scales it to
    width×height metres, rotates by yaw/pitch/roll and places it pan_x/pan_y
    across and `distance` metres in front of the viewer (-Z forward).
    """

    width: float = 4.0
    height: float = 2.25
    distance: float = 3.0
    pan_x: float = 0.0
    pan_y: float = 0.0
    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0
    seat_height: float = 0.0

    def with_aspect(self, aspect: float) -> "ScreenPose":
        """Keep width, set height from a frame aspect (w/h)."""
        return replace(self, height=self.width / max(aspect, 1e-6))

    def with_preset(self, index: int) -> "ScreenPose":
        name, width, dist = SCREEN_PRESETS[index % len(SCREEN_PRESETS)]
        del name
        aspect = self.width / max(self.height, 1e-6)
        return replace(self, width=width, height=width / aspect,
                       distance=dist, pan_x=0.0, pan_y=0.0,
                       yaw=0.0, pitch=0.0, roll=0.0)

    # ---- matrices -----------------------------------------------------------

    def rotation(self) -> np.ndarray:
        return _rotation_ypr(self.yaw, self.pitch, self.roll)

    def model_matrix(self, normal_offset: float = 0.0) -> np.ndarray:
        """T · R · S: local quad [-1,1]² → world.  `normal_offset` pushes the
        surface along its forward normal (for border/glow layers)."""
        s = np.diag([self.width / 2.0, self.height / 2.0, 1.0, 1.0]).astype(np.float32)
        r = self.rotation()
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = self.pan_x
        t[1, 3] = self.pan_y + self.seat_height
        t[2, 3] = -self.distance
        if normal_offset:
            t[:3, 3] += r[:3, 2] * normal_offset
        return (t @ r @ s).astype(np.float32)

    # ---- meshes -------------------------------------------------------------

    def flat_mesh(self) -> np.ndarray:
        """Triangle-strip quad, local space: 4 vertices × (x y z u v)."""
        return np.array(
            [
                [-1.0, -1.0, 0.0, 0.0, 0.0],
                [+1.0, -1.0, 0.0, 1.0, 0.0],
                [-1.0, +1.0, 0.0, 0.0, 1.0],
                [+1.0, +1.0, 0.0, 1.0, 1.0],
            ],
            dtype=np.float32,
        )

    def curved_mesh(self, segments: int = 48, axis: str = "horizontal",
                    dist_offset: float = 0.0,
                    normal_offset: float = 0.0) -> np.ndarray:
        """World-space triangle strip for a cylinder-section screen,
        (segments+1)*2 vertices × (x y z u v).

        The arc keeps CURVED_HALF_ANGLE_RAD for every size, so the radius
        scales with the curved extent (width for horizontal, height for
        vertical) and the perceived curvature is size-invariant."""
        half_w, half_h = self.width / 2.0, self.height / 2.0
        half_ang = min(CURVED_HALF_ANGLE_RAD, math.pi / 2)
        rot = self.rotation()[:3, :3]
        center = np.array(
            [self.pan_x, self.pan_y + self.seat_height, -self.distance],
            np.float32)
        normal = rot[:, 2]

        n_cols = segments + 1
        angles = np.linspace(-half_ang, half_ang, n_cols)
        sin_a, cos_a = np.sin(angles), np.cos(angles)
        tex = np.linspace(0.0, 1.0, n_cols, dtype=np.float32)

        if axis == "vertical":
            radius = half_h / max(half_ang, 1e-6)
            along = np.stack(  # [n_cols, 3] arc in the (y, z) plane
                [np.zeros(n_cols), radius * sin_a,
                 radius * (1.0 - cos_a) - dist_offset], axis=1)
            across = np.array([[-half_w, 0.0, 0.0], [half_w, 0.0, 0.0]])
            uv = np.stack(  # arc drives v, across drives u
                [np.stack([np.zeros(n_cols), tex], 1),
                 np.stack([np.ones(n_cols), tex], 1)], axis=1)
        else:
            radius = half_w / max(half_ang, 1e-6)
            along = np.stack(
                [radius * sin_a, np.zeros(n_cols),
                 radius * (1.0 - cos_a) - dist_offset], axis=1)
            across = np.array([[0.0, -half_h, 0.0], [0.0, half_h, 0.0]])
            uv = np.stack(
                [np.stack([tex, np.zeros(n_cols)], 1),
                 np.stack([tex, np.ones(n_cols)], 1)], axis=1)

        local = along[:, None, :] + across[None, :, :]           # [n_cols, 2, 3]
        world = local @ rot.T + center + normal * normal_offset  # [n_cols, 2, 3]
        out = np.concatenate([world, uv], axis=2)                # [n_cols, 2, 5]
        return out.reshape(-1, 5).astype(np.float32)


@dataclass
class GrabState:
    """Grab-to-move/resize bookkeeping (reference screen.py:280-520): a held
    grip anchors the screen pose; motion deltas re-pose it."""

    anchor_pose: ScreenPose = field(default_factory=ScreenPose)
    anchor_hand: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    active: bool = False

    def begin(self, pose: ScreenPose, hand: Tuple[float, float, float]) -> None:
        self.anchor_pose, self.anchor_hand, self.active = pose, tuple(hand), True

    def update(self, hand: Tuple[float, float, float]) -> ScreenPose:
        if not self.active:
            return self.anchor_pose
        dx = hand[0] - self.anchor_hand[0]
        dy = hand[1] - self.anchor_hand[1]
        dz = hand[2] - self.anchor_hand[2]
        return replace(
            self.anchor_pose,
            pan_x=self.anchor_pose.pan_x + dx,
            pan_y=self.anchor_pose.pan_y + dy,
            distance=max(0.2, self.anchor_pose.distance - dz),
        )

    def end(self) -> None:
        self.active = False
