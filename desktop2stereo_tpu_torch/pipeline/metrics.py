"""Per-stage latency and FPS statistics (`desktop2stereo_tpu/pipeline/metrics.py`).

A copy rather than an import: importing anything from the JAX package pulls
in its config module (PyYAML) and JAX itself, which a CUDA host need not have.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional


class StageLatency:
    """The EMA of each named stage's latency (its first sample as it is)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ema: Dict[str, float] = {}

    def record(self, stage: str, seconds: float, ema_alpha: float = 0.9) -> None:
        with self._lock:
            prev = self._ema.get(stage)
            self._ema[stage] = seconds if prev is None else prev * ema_alpha + seconds * (1 - ema_alpha)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._ema)


class FpsCounter:
    """Rolling-window FPS: average and 1%-low."""

    def __init__(self, window: int = 240) -> None:
        self._times: Deque[float] = deque(maxlen=window + 1)
        self._lock = threading.Lock()

    def tick(self, now: Optional[float] = None) -> None:
        with self._lock:
            self._times.append(now if now is not None else time.perf_counter())

    def stats(self) -> Dict[str, float]:
        with self._lock:
            ts = list(self._times)
        deltas = [b - a for a, b in zip(ts, ts[1:]) if b > a]
        if not deltas:
            return {"fps": 0.0, "fps_1pct_low": 0.0, "frame_ms": 0.0}
        avg = sum(deltas) / len(deltas)
        worst = sorted(deltas)[min(len(deltas) - 1, int(len(deltas) * 0.99))]
        return {
            "fps": 1.0 / avg,
            "fps_1pct_low": 1.0 / worst if worst > 0 else 0.0,
            "frame_ms": avg * 1000.0,
        }
