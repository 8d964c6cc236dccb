"""Synthetic animated desktop: deterministic, allocation-light frame source.

Generates a scene with depth-varied content (gradient background, moving
window rectangles, scrolling text bar) so the depth model sees structure and
the stereo stage sees parallax — the analog of the reference's
white-frame standalone test (reference xrviewer.py:13-14), but rich enough
for FPS benchmarking.  Port of `desktop2stereo_tpu/sources/synthetic.py`:
the same frames for the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SyntheticSource:
    def __init__(
        self,
        size: Tuple[int, int] = (1080, 1920),
        channels: int = 4,
        max_frames: Optional[int] = None,
        seed: int = 0,
    ) -> None:
        self.h, self.w = size
        self.channels = channels
        self.max_frames = max_frames
        self._i = 0
        rng = np.random.default_rng(seed)
        y, x = np.mgrid[0 : self.h, 0 : self.w]
        base = np.empty((self.h, self.w, channels), dtype=np.uint8)
        base[..., 0] = (x * 255 // max(self.w, 1)).astype(np.uint8)   # B
        base[..., 1] = (y * 255 // max(self.h, 1)).astype(np.uint8)   # G
        base[..., 2] = 96                                              # R
        if channels == 4:
            base[..., 3] = 255
        self._base = base
        self._noise = (rng.random((64, 64)) * 255).astype(np.uint8)
        # DOUBLE-buffered working frames: the engine's upload of frame N
        # (its copy into the pinned staging buffer) may still be reading
        # its host buffer when grab() composes frame N+1, so the two must
        # not share memory (the depth-1 mailbox keeps at most one frame in
        # flight → two buffers suffice)
        self._frames = (base.copy(), base.copy())

    def grab(self) -> Optional[np.ndarray]:
        if self.max_frames is not None and self._i >= self.max_frames:
            return None
        i = self._i
        self._i += 1
        f = self._frames[i % 2]
        np.copyto(f, self._base)
        # moving "window" (near object)
        wx = int((self.w - 400) * (0.5 + 0.5 * np.sin(i * 0.05)))
        wy = int((self.h - 300) * (0.5 + 0.5 * np.cos(i * 0.03)))
        f[wy : wy + 280, wx : wx + 380, :3] = 230
        f[wy : wy + 24, wx : wx + 380, :3] = 60  # title bar
        # second, farther window
        f[self.h // 4 : self.h // 4 + 200, self.w // 8 : self.w // 8 + 300, :3] = 180
        # texture patch so the image is not flat (clamped for tiny frames)
        th = min(self._noise.shape[0], self.h)
        tw = min(self._noise.shape[1], self.w)
        f[:th, self.w - tw :, :3] = self._noise[:th, :tw, None]
        return f

    def close(self) -> None:
        pass
