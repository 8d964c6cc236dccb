"""Latest-frame mailbox for remote XR clients.

Port of `desktop2stereo_tpu/xr/frame_server.py`.  The reference's OpenXR
viewer drains its depth queue keeping only the newest entry before
uploading (reference xr_viewer/implementation.py:1446-1651); this is that
contract as a renderer-agnostic server: the pipeline pushes
`update_frame(rgb, depth)` (reference viewer.py:2359) and a client polls
`latest()` at its own display rate.  Single-slot and lock-guarded: a slow
client never backpressures the pipeline.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class FramePacket:
    rgb: np.ndarray                 # [H, W, 3] uint8
    depth: Optional[np.ndarray]     # [H, W] float32 in [0,1], or None
    seq: int
    timestamp: float


class FrameServer:
    """Thread-safe latest-wins frame slot with client-side change detection."""

    def __init__(self):
        self._lock = threading.Lock()
        self._packet: Optional[FramePacket] = None
        self._seq = 0
        self._new = threading.Event()

    # ---- producer side (pipeline sink) ---------------------------------------

    def update_frame(self, rgb: np.ndarray,
                     depth: Optional[np.ndarray] = None) -> None:
        rgb = np.ascontiguousarray(rgb)
        if depth is not None:
            depth = np.ascontiguousarray(depth, dtype=np.float32)
        with self._lock:
            self._seq += 1
            self._packet = FramePacket(rgb, depth, self._seq, time.monotonic())
        self._new.set()

    # ---- consumer side (XR client poll loop) ---------------------------------

    def latest(self, last_seen: int = -1,
               timeout: Optional[float] = None) -> Optional[FramePacket]:
        """Newest packet, or None if nothing newer than `last_seen` arrived
        within `timeout` (None = non-blocking)."""
        if timeout:
            deadline = time.monotonic() + timeout
            while True:
                # Clear BEFORE reading the packet: a publish landing after
                # the read re-sets the event, so wait() returns immediately
                # instead of eating the notification and stalling a full
                # timeout (lost-wakeup race).
                self._new.clear()
                with self._lock:
                    p = self._packet
                if p is not None and p.seq != last_seen:
                    return p
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._new.wait(remaining)
        with self._lock:
            p = self._packet
        return p if p is not None and p.seq != last_seen else None

    # ---- sink protocol (duck-typed like sinks/*) ------------------------------

    def write(self, sbs: np.ndarray, depth: Optional[np.ndarray] = None) -> None:
        self.update_frame(sbs, depth)

    def close(self) -> None:
        self._new.set()

    @property
    def frames_served(self) -> int:
        return self._seq

    def geometry_for(self, aspect: float):
        """Convenience: a default screen pose sized to the stream aspect."""
        from desktop2stereo_tpu_torch.xr.geometry import ScreenPose

        return ScreenPose().with_aspect(aspect)
