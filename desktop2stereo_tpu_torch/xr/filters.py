"""Pose smoothing primitives for XR input.

Port of `desktop2stereo_tpu/xr/filters.py`, copied: host numpy.

The 1€ filter (Casiez, Roussel & Vogel, CHI 2012) as used for controller
hand-jitter reduction (reference xr_viewer/input.py:474-580) and quaternion
slerp for aim/grip pose smoothing (reference xr_viewer/laser.py:25-120).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np


class OneEuroFilter:
    """Adaptive first-order low-pass: cutoff rises with speed so slow motion
    is smoothed hard while fast motion stays responsive.

    x̂ follows  f_c = min_cutoff + beta·|dx̂|  with an RC low-pass
    α = 1/(1 + τ/dt), τ = 1/(2π f_c) on both the signal and its derivative.
    """

    def __init__(self, min_cutoff: float = 1.2, beta: float = 0.01,
                 derivative_cutoff: float = 1.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.derivative_cutoff = float(derivative_cutoff)
        self._x: Optional[float] = None
        self._dx: Optional[float] = None

    def reset(self) -> None:
        self._x = None
        self._dx = None

    @staticmethod
    def _alpha(cutoff: float, dt: float) -> float:
        if dt <= 0.0:
            return 1.0
        tau = 1.0 / (2.0 * math.pi * max(cutoff, 1e-3))
        return 1.0 / (1.0 + tau / dt)

    def __call__(self, x: float, dt: float) -> float:
        x = float(x)
        if self._x is None:
            self._x, self._dx = x, 0.0
            return x
        dx = (x - self._x) / dt if dt > 0.0 else 0.0
        a_d = self._alpha(self.derivative_cutoff, dt)
        self._dx = a_d * dx + (1.0 - a_d) * self._dx
        cutoff = self.min_cutoff + self.beta * abs(self._dx)
        a = self._alpha(cutoff, dt)
        self._x = a * x + (1.0 - a) * self._x
        return self._x


class OneEuroFilter3D:
    """Independent per-axis 1€ filters for a 3-vector (position)."""

    def __init__(self, min_cutoff: float = 1.2, beta: float = 0.01,
                 derivative_cutoff: float = 1.0):
        self._f = tuple(
            OneEuroFilter(min_cutoff, beta, derivative_cutoff) for _ in range(3))

    def reset(self) -> None:
        for f in self._f:
            f.reset()

    def __call__(self, pos: Sequence[float], dt: float) -> Tuple[float, float, float]:
        return tuple(f(float(p), dt) for f, p in zip(self._f, pos))  # type: ignore


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation between unit quaternions [x,y,z,w], taking
    the short arc; falls back to normalized lerp when nearly parallel."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        out = q0 + t * (q1 - q0)
        return (out / np.linalg.norm(out)).astype(np.float32)
    theta = math.acos(min(1.0, dot))
    s = math.sin(theta)
    out = (math.sin((1.0 - t) * theta) / s) * q0 + (math.sin(t * theta) / s) * q1
    return out.astype(np.float32)
