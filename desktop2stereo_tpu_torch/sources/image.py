"""Still-image source: loops one image (the golden-input harness, analog of
the reference's depth_visualize.py cats.jpg loop).  Port of
`desktop2stereo_tpu/sources/image.py`; PIL is imported when the source is
made, so the package imports without it."""

from __future__ import annotations

from typing import Optional

import numpy as np


class ImageSource:
    def __init__(self, path: str, max_frames: Optional[int] = None, bgra: bool = True) -> None:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"))
        if bgra:  # capture layout is BGRA (reference capture path)
            frame = np.empty((*img.shape[:2], 4), dtype=np.uint8)
            frame[..., 0] = img[..., 2]
            frame[..., 1] = img[..., 1]
            frame[..., 2] = img[..., 0]
            frame[..., 3] = 255
        else:
            frame = img
        self._frame = frame
        self.max_frames = max_frames
        self._i = 0

    def grab(self) -> Optional[np.ndarray]:
        if self.max_frames is not None and self._i >= self.max_frames:
            return None
        self._i += 1
        return self._frame

    def close(self) -> None:
        pass
