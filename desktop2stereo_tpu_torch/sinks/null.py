"""Null sink: swallows frames (benchmarking the compute path).

Port of `desktop2stereo_tpu/sinks/null.py`.
"""

from __future__ import annotations

import numpy as np


class NullSink:
    # engine skips the device->host depth fetch for sinks that never read it
    wants_depth = False

    def __init__(self) -> None:
        self.frames = 0
        self.last_shape = None

    def push(self, sbs_u8: np.ndarray, depth, stats) -> None:
        self.frames += 1
        self.last_shape = sbs_u8.shape

    def close(self) -> None:
        pass
