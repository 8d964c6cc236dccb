"""Video-file source via OpenCV (host-side decode feeding the pipeline).

Port of `desktop2stereo_tpu/sources/video.py`; cv2 is imported when the
source is made, so the package imports without it."""

from __future__ import annotations

from typing import Optional

import numpy as np


class VideoSource:
    def __init__(self, path: str, loop: bool = False, max_frames: Optional[int] = None) -> None:
        import cv2

        self._cv2 = cv2
        self.path = path
        self.loop = loop
        self.max_frames = max_frames
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        self._i = 0

    def grab(self) -> Optional[np.ndarray]:
        if self.max_frames is not None and self._i >= self.max_frames:
            return None
        ok, frame = self._cap.read()
        if not ok:
            if not self.loop:
                return None
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
            ok, frame = self._cap.read()
            if not ok:
                return None
        self._i += 1
        return frame  # BGR uint8 — pipeline handles BGR(A)→RGB

    def close(self) -> None:
        self._cap.release()
