"""PNG sink: writes every Nth composed frame (debug/golden harness).

Port of `desktop2stereo_tpu/sinks/png.py`; PIL is imported when a frame is
written, so the package imports without it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class PngSink:
    def __init__(self, out_dir: str, every: int = 1, save_depth: bool = False, limit: Optional[int] = None) -> None:
        self.out_dir = out_dir
        self.every = max(1, every)
        self.save_depth = save_depth
        # only pay the depth d2h when depth files were actually requested
        self.wants_depth = bool(save_depth)
        self.limit = limit
        self.frames = 0
        self.written = 0
        os.makedirs(out_dir, exist_ok=True)

    def push(self, sbs_u8: np.ndarray, depth, stats) -> None:
        from PIL import Image

        i = self.frames
        self.frames += 1
        if i % self.every:
            return
        if self.limit is not None and self.written >= self.limit:
            return
        Image.fromarray(sbs_u8).save(os.path.join(self.out_dir, f"sbs_{i:06d}.png"))
        if self.save_depth and depth is not None:
            d = np.asarray(depth)
            Image.fromarray((np.clip(d, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(self.out_dir, f"depth_{i:06d}.png")
            )
        self.written += 1

    def close(self) -> None:
        pass
