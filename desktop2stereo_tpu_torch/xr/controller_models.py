"""Procedural controller models for in-headset rendering.

Port of `desktop2stereo_tpu/xr/controller_models.py`, copied: host numpy.

The reference ships per-vendor GLB controller meshes
(reference xr_viewer/controllers/*, rendered by xr_viewer/laser.py:25-833
with a brand-switch combo).  Shipping third-party binary assets is not an
option here, so each vendor gets a recognizable PROCEDURAL stand-in built
from the same primitives (grip body, head, tracking ring, trigger wedge)
with a vendor accent color.  Output is a triangle soup in controller-local
space — grip at the origin, -Z forward, +Y up — ready for a DrawItem.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

# Vendor accent colors (body stays near-black like the real devices).
VENDOR_ACCENTS: Dict[str, Tuple[float, float, float]] = {
    "generic": (0.55, 0.58, 0.62),
    "quest": (0.85, 0.85, 0.88),
    "vive": (0.20, 0.55, 0.95),
    "index": (0.90, 0.35, 0.25),
    "pico": (0.30, 0.85, 0.55),
    "yvr": (0.80, 0.70, 0.25),
    "hp": (0.55, 0.30, 0.85),
}
VENDORS = tuple(VENDOR_ACCENTS)

_BODY = (0.020, 0.020, 0.055)     # half-extents of the grip box (metres)
_HEAD = (0.026, 0.012, 0.030)
_RING_R = 0.042
_RING_TUBE = 0.006
_RING_SEGS = 16


def _box(cx, cy, cz, hx, hy, hz, color):
    """Axis-aligned box → (verts [36,3], normals [36,3], colors [36,4])."""
    faces = [
        ((+1, 0, 0), (0, +1, 0), (0, 0, +1)),
        ((-1, 0, 0), (0, +1, 0), (0, 0, -1)),
        ((0, +1, 0), (0, 0, +1), (+1, 0, 0)),
        ((0, -1, 0), (0, 0, -1), (+1, 0, 0)),
        ((0, 0, +1), (0, +1, 0), (-1, 0, 0)),
        ((0, 0, -1), (0, +1, 0), (+1, 0, 0)),
    ]
    he = np.array([hx, hy, hz])
    c = np.array([cx, cy, cz])
    verts, norms = [], []
    for n, u, v in faces:
        n = np.array(n, np.float32)
        u = np.array(u, np.float32)
        v = np.array(v, np.float32)
        corners = [c + (n + su * u + sv * v) * he
                   for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        for i in (0, 1, 2, 0, 2, 3):
            verts.append(corners[i])
            norms.append(n)
    verts = np.asarray(verts, np.float32)
    norms = np.asarray(norms, np.float32)
    cols = np.tile(np.asarray(list(color) + [1.0], np.float32),
                   (len(verts), 1))
    return verts, norms, cols


def _ring(center_z: float, color, radius: float = _RING_R,
          tube: float = _RING_TUBE, segs: int = _RING_SEGS):
    """Flattened torus approximation: a strip of quads around the ring
    plane (y ≈ 0), enough silhouette to read as a tracking ring."""
    verts, norms = [], []
    for i in range(segs):
        a0 = 2 * math.pi * i / segs
        a1 = 2 * math.pi * (i + 1) / segs
        for a, b in ((a0, a1),):
            p0 = np.array([math.cos(a) * radius, 0.0,
                           center_z + math.sin(a) * radius])
            p1 = np.array([math.cos(b) * radius, 0.0,
                           center_z + math.sin(b) * radius])
            n0 = np.array([math.cos(a), 0.0, math.sin(a)], np.float32)
            n1 = np.array([math.cos(b), 0.0, math.sin(b)], np.float32)
            up = np.array([0.0, tube, 0.0])
            quad = [p0 - up, p1 - up, p1 + up, p0 + up]
            qn = [n0, n1, n1, n0]
            for j in (0, 1, 2, 0, 2, 3):
                verts.append(quad[j])
                norms.append(qn[j])
    verts = np.asarray(verts, np.float32)
    norms = np.asarray(norms, np.float32)
    cols = np.tile(np.asarray(list(color) + [1.0], np.float32),
                   (len(verts), 1))
    return verts, norms, cols


def controller_mesh(vendor: str = "generic", hand: str = "left"):
    """(verts [N,3], normals [N,3], colors [N,4]) in controller-local
    space.  The ring tilts toward the thumb side, mirrored per hand."""
    accent = VENDOR_ACCENTS.get(vendor.lower(), VENDOR_ACCENTS["generic"])
    body_col = (0.09, 0.09, 0.11)
    parts = [
        _box(0.0, 0.0, 0.01, *_BODY, body_col),               # grip
        _box(0.0, 0.014, -0.052, *_HEAD, accent),              # head/buttons
        _box(0.0, -0.012, -0.052, 0.012, 0.008, 0.014, body_col),  # trigger
    ]
    ring_v, ring_n, ring_c = _ring(-0.052, accent)
    # tilt the ring ~35° about X, offset toward the head
    tilt = math.radians(35.0 if hand == "left" else -35.0)
    ct, st = math.cos(tilt), math.sin(tilt)
    rot = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], np.float32)
    ring_v = ring_v @ rot.T
    ring_n = ring_n @ rot.T
    parts.append((ring_v, ring_n, ring_c))
    verts = np.concatenate([p[0] for p in parts])
    norms = np.concatenate([p[1] for p in parts])
    cols = np.concatenate([p[2] for p in parts])
    return verts, norms, cols


def next_vendor(current: str) -> str:
    """Cycle order for the brand-switch combo (reference
    input_handler.py:1039-1055)."""
    try:
        i = VENDORS.index(current.lower())
    except ValueError:
        i = -1
    return VENDORS[(i + 1) % len(VENDORS)]
