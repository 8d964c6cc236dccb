"""Shared-memory frame source: consume frames an external producer writes
into the native ring (desktop2stereo_tpu_torch.native.ShmFrameRing).

Port of `desktop2stereo_tpu/sources/shm.py`.  This is the transport for
real deployments: a capture agent (another process, possibly forwarding
from a workstation) writes BGRA frames into POSIX shm; the pipeline reads
latest-wins with one memcpy, and `FrameEngine` stages each frame through
pinned memory to the card.  The ring's layout is `native/d2s_native.cpp`'s,
shared with the JAX package's binding.

Producer side example:
    from desktop2stereo_tpu_torch.native import ShmFrameRing
    ring = ShmFrameRing("/d2s_frames", max_bytes=3840*2160*4, slots=3)
    ring.write(frame_bgra)
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from desktop2stereo_tpu_torch.native import ShmFrameRing


class ShmSource:
    def __init__(self, name: str = "/d2s_frames", timeout: float = 5.0,
                 max_frames: Optional[int] = None):
        self.ring = ShmFrameRing(name, create=False)
        self.timeout = timeout
        self.max_frames = max_frames
        self._i = 0

    def grab(self) -> Optional[np.ndarray]:
        if self.max_frames is not None and self._i >= self.max_frames:
            return None
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            got = self.ring.read_latest()
            if got is not None:
                self._i += 1
                return got[0]
            time.sleep(0.002)
        return None  # producer went away

    def close(self) -> None:
        self.ring.close()
