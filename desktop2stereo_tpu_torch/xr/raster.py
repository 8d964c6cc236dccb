"""Software 3D rasterizer + camera math for the XR theater.

Port of `desktop2stereo_tpu/xr/raster.py`, copied: host numpy, the same
pixels.

The reference renders its virtual theater (environment scene, screen quad,
glow band, laser beams, OSD quads) with moderngl per eye (reference
xr_viewer/implementation.py:1880-2045, render.py:981-1054).  On this side
the same scene is expressed as renderer-agnostic `DrawItem`s
(xr/theater.py) and two backends consume them: the PyOpenGL backend
(xr/gl_theater.py) on a workstation, and THIS numpy rasterizer — the
headless reference implementation used by the png/cv presenters and by
the offline tests that pin the theater's pixels.

Conventions are OpenGL's: right-handed view space looking down -Z, clip
space with z in [-w, w], NDC y up.  Perspective-correct attribute
interpolation, z-buffer, alpha/additive blending.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- camera ---


def proj_from_fov(fov: Sequence[float], near: float = 0.05,
                  far: float = 200.0) -> np.ndarray:
    """OpenXR asymmetric-frustum projection from (left, right, up, down)
    half-angles in radians (reference xr_viewer/render.py:981-1054)."""
    lt, rt, up, dn = (math.tan(a) for a in fov)
    w, h = rt - lt, up - dn
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 2.0 / w
    m[1, 1] = 2.0 / h
    m[0, 2] = (rt + lt) / w
    m[1, 2] = (up + dn) / h
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def symmetric_proj(fov_y_deg: float, aspect: float, near: float = 0.05,
                   far: float = 200.0) -> np.ndarray:
    half = math.radians(fov_y_deg) / 2.0
    # aspect scales the TANGENT (frustum width), not the angle
    half_x = math.atan(math.tan(half) * aspect)
    return proj_from_fov((-half_x, half_x, half, -half), near, far)


def quat_matrix(q_xyzw: Sequence[float]) -> np.ndarray:
    x, y, z, w = (float(v) for v in q_xyzw)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def view_from_pose(position: Sequence[float],
                   orientation_xyzw: Sequence[float]) -> np.ndarray:
    """Inverse of a rigid pose: world → eye (the per-eye view matrix from
    xr.locate_views poses, reference render.py:1030-1054)."""
    r = quat_matrix(orientation_xyzw)
    v = np.eye(4, dtype=np.float32)
    v[:3, :3] = r.T
    v[:3, 3] = -r.T @ np.asarray(position, np.float32)
    return v


def view_translate(eye_pos: Sequence[float]) -> np.ndarray:
    """Axis-aligned camera at `eye_pos` looking down -Z (the seated
    non-tracked camera of the flat-window presenters)."""
    v = np.eye(4, dtype=np.float32)
    v[:3, 3] = -np.asarray(eye_pos, np.float32)
    return v


# -------------------------------------------------------------- DrawItem ---


@dataclass
class DrawItem:
    """One renderer-agnostic draw call.

    `verts` [N,3] world positions; `mode` "triangles" (soup or indexed) or
    "strip".  Optional per-vertex `uvs` [N,2] / `colors` [N,4] (linear
    0..1); `texture` RGB/RGBA uint8 sampled at uvs, modulated by colors
    and `color`.  `kind` tags the semantic role so GL backends can bind
    special programs (the "screen" item renders the DIBR warp in-shader)."""

    kind: str
    verts: np.ndarray
    mode: str = "triangles"
    uvs: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None
    indices: Optional[np.ndarray] = None
    texture: Optional[np.ndarray] = None
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    blend: str = "opaque"          # "opaque" | "alpha" | "additive"
    depth_write: bool = True
    depth_test: bool = True
    wrap_u: bool = False           # panorama longitude wrap
    uniforms: dict = field(default_factory=dict)  # screen-DIBR params


def _as_triangles(item: DrawItem) -> np.ndarray:
    """Vertex-index triplets [T,3] for any mode."""
    n = item.verts.shape[0]
    if item.indices is not None:
        idx = np.asarray(item.indices, np.int64).reshape(-1, 3)
    elif item.mode == "strip":
        base = np.arange(n - 2, dtype=np.int64)
        a, b, c = base, base + 1, base + 2
        # strip parity: odd triangles flip winding
        odd = base % 2 == 1
        b2 = np.where(odd, c, b)
        c2 = np.where(odd, b, c)
        idx = np.stack([a, b2, c2], axis=1)
    else:
        idx = np.arange(n - n % 3, dtype=np.int64).reshape(-1, 3)
    return idx


# ------------------------------------------------------------ rasterizer ---

_NEAR_EPS = 1e-6


def _clip_near(tri_attrs: np.ndarray) -> list:
    """Sutherland-Hodgman clip of one triangle against the near plane
    z + w > 0 in clip space.  `tri_attrs` [3, K] with columns
    (x y z w, ...attributes).  Returns a list of [3, K] triangles."""
    f = tri_attrs[:, 2] + tri_attrs[:, 3]
    inside = f > _NEAR_EPS
    if inside.all():
        return [tri_attrs]
    if not inside.any():
        return []
    out = []
    for i in range(3):
        a, b = tri_attrs[i], tri_attrs[(i + 1) % 3]
        fa, fb = f[i], f[(i + 1) % 3]
        if fa > _NEAR_EPS:
            out.append(a)
        if (fa > _NEAR_EPS) != (fb > _NEAR_EPS):
            t = fa / (fa - fb)
            out.append(a + (b - a) * t)
    tris = []
    for i in range(1, len(out) - 1):
        tris.append(np.stack([out[0], out[i], out[i + 1]]))
    return tris


class SoftRaster:
    """Z-buffered triangle rasterizer over numpy; one instance per target."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.color = np.zeros((self.height, self.width, 3), np.float32)
        self.zbuf = np.full((self.height, self.width), np.inf, np.float32)

    def begin(self, clear_rgb: Sequence[float]) -> None:
        self.color[:] = np.asarray(clear_rgb, np.float32)
        self.zbuf[:] = np.inf

    # -- public ------------------------------------------------------------

    def draw(self, item: DrawItem, view: np.ndarray, proj: np.ndarray) -> None:
        verts = np.asarray(item.verts, np.float32)
        n = verts.shape[0]
        if n < 3:
            return
        mvp = (proj @ view).astype(np.float32)
        clip = verts @ mvp[:3, :3].T + mvp[:3, 3]
        wrow = verts @ mvp[3, :3] + mvp[3, 3]
        pos = np.concatenate([clip, wrow[:, None]], axis=1)  # [N,4] (xyz w)

        uvs = (np.asarray(item.uvs, np.float32) if item.uvs is not None
               else np.zeros((n, 2), np.float32))
        if item.colors is not None:
            cols = np.asarray(item.colors, np.float32)
            if cols.shape[1] == 3:
                cols = np.concatenate(
                    [cols, np.ones((n, 1), np.float32)], axis=1)
        else:
            cols = np.ones((n, 4), np.float32)
        cols = cols * np.asarray(item.color, np.float32)

        attrs = np.concatenate([pos, uvs, cols], axis=1)  # [N, 10]
        tex = item.texture
        if tex is not None and tex.dtype != np.float32:
            tex = tex.astype(np.float32) / 255.0

        for tri_idx in _as_triangles(item):
            tri = attrs[tri_idx]
            # skip degenerate index rows (strip restarts would need them)
            for clipped in _clip_near(tri):
                self._raster_tri(clipped, tex, item)

    def image_u8(self) -> np.ndarray:
        return np.clip(self.color * 255.0 + 0.5, 0, 255).astype(np.uint8)

    # -- internals -----------------------------------------------------------

    def _raster_tri(self, tri: np.ndarray, tex: Optional[np.ndarray],
                    item: DrawItem) -> None:
        w = tri[:, 3]
        inv_w = 1.0 / w
        ndc = tri[:, :3] * inv_w[:, None]
        xs = (ndc[:, 0] * 0.5 + 0.5) * self.width
        ys = (0.5 - ndc[:, 1] * 0.5) * self.height
        zs = ndc[:, 2]

        x0 = max(int(np.floor(xs.min())), 0)
        x1 = min(int(np.ceil(xs.max())) + 1, self.width)
        y0 = max(int(np.floor(ys.min())), 0)
        y1 = min(int(np.ceil(ys.max())) + 1, self.height)
        if x0 >= x1 or y0 >= y1:
            return

        area = ((xs[1] - xs[0]) * (ys[2] - ys[0])
                - (xs[2] - xs[0]) * (ys[1] - ys[0]))
        if abs(area) < 1e-12:
            return

        px, py = np.meshgrid(
            np.arange(x0, x1, dtype=np.float32) + 0.5,
            np.arange(y0, y1, dtype=np.float32) + 0.5)

        def edge(ax, ay, bx, by):
            return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

        e0 = edge(xs[1], ys[1], xs[2], ys[2])
        e1 = edge(xs[2], ys[2], xs[0], ys[0])
        e2 = edge(xs[0], ys[0], xs[1], ys[1])
        if area < 0:
            e0, e1, e2, a = -e0, -e1, -e2, -area
        else:
            a = area
        mask = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
        if not mask.any():
            return

        b0 = e0 / a
        b1 = e1 / a
        b2 = e2 / a
        # perspective-correct: interpolate attr/w and 1/w
        iw = b0 * inv_w[0] + b1 * inv_w[1] + b2 * inv_w[2]
        z = b0 * zs[0] + b1 * zs[1] + b2 * zs[2]

        sub_z = self.zbuf[y0:y1, x0:x1]
        if item.depth_test:
            mask &= z < sub_z
            if not mask.any():
                return

        def interp(col: int) -> np.ndarray:
            vals = tri[:, col] * inv_w
            return (b0 * vals[0] + b1 * vals[1] + b2 * vals[2]) / iw

        r = interp(6)
        g = interp(7)
        bcol = interp(8)
        alpha = interp(9)
        if tex is not None:
            u = interp(4)
            v = interp(5)
            th, tw = tex.shape[:2]
            ui = (u * tw).astype(np.int64)
            ui = ui % tw if item.wrap_u else np.clip(ui, 0, tw - 1)
            # v=0 is the texture TOP (image row 0) — quad builders emit uvs
            # in image convention
            vi = np.clip((v * th).astype(np.int64), 0, th - 1)
            texel = tex[vi, ui]
            r = r * texel[..., 0]
            g = g * texel[..., 1]
            bcol = bcol * texel[..., 2]
            if texel.shape[-1] == 4:
                alpha = alpha * texel[..., 3]

        src = np.stack([r, g, bcol], axis=-1)
        dst = self.color[y0:y1, x0:x1]
        m3 = mask[..., None]
        if item.blend == "additive":
            out = dst + src * alpha[..., None]
        elif item.blend == "alpha":
            out = dst * (1.0 - alpha[..., None]) + src * alpha[..., None]
        else:
            out = src
        dst[:] = np.where(m3, out, dst)
        if item.depth_write and item.blend == "opaque":
            sub_z[:] = np.where(mask, z, sub_z)


def render_items(width: int, height: int, clear_rgb: Sequence[float],
                 items: Sequence[DrawItem], view: np.ndarray,
                 proj: np.ndarray) -> np.ndarray:
    """One-shot helper: draw `items` in order → RGB uint8 [H, W, 3]."""
    r = SoftRaster(width, height)
    r.begin(clear_rgb)
    for item in items:
        r.draw(item, view, proj)
    return r.image_u8()
