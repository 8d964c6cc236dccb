"""Video-file sink via OpenCV VideoWriter (headless recording).

Port of `desktop2stereo_tpu/sinks/video.py`; cv2 is imported when the
writer opens, so the package imports without it.
"""

from __future__ import annotations

import numpy as np


class VideoSink:
    # engine skips the device->host depth fetch for sinks that never read it
    wants_depth = False

    def __init__(self, path: str, fps: float = 30.0, codec: str = "mp4v") -> None:
        self.path = path
        self.fps = fps
        self.codec = codec
        self._writer = None
        self._size = None  # (w, h) the writer was opened for
        self._segment = 0

    def _open(self, w: int, h: int) -> None:
        import cv2

        path = self.path
        if self._segment:
            # size changed mid-run: cv2.VideoWriter silently drops
            # mismatched frames, so start a numbered continuation file
            # (the RTMP sink's restart-on-resize analog, rtmp.py:106-109)
            import os

            root, ext = os.path.splitext(self.path)
            path = f"{root}.seg{self._segment}{ext}"
            print(f"[video] frame size changed to {w}x{h}; continuing in {path}")
        self._writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*self.codec), self.fps, (w, h)
        )
        if not self._writer.isOpened():
            raise RuntimeError(f"VideoWriter failed to open {path!r} "
                               f"({self.codec}, {w}x{h})")
        self._size = (w, h)

    def push(self, sbs_u8: np.ndarray, depth, stats) -> None:
        h, w = sbs_u8.shape[:2]
        if self._writer is not None and self._size != (w, h):
            self._writer.release()
            self._writer = None
            self._segment += 1
        if self._writer is None:
            self._open(w, h)
        self._writer.write(sbs_u8[..., ::-1])  # RGB→BGR

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None
