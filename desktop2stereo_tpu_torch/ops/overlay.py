"""FPS overlay: a 3x5 bitmap font rendered as a mask, blended over a frame.

Port of `desktop2stereo_tpu/ops/overlay.py` (the reference's tensor font
overlay, reference depth.py:641-658 font table, 2027-2103 overlay_fps): a
tiny fixed glyph set ("FPS: 12.3") scaled to the frame and blended green
over the top-left corner.  The mask is built on the host with numpy once per
text change (the reference rebuilds every 10 frames); the blend runs on the
device of the tensor it is given, and a numpy frame is blended on the host
and returned as numpy (the sinks hand it host frames).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

# Classic 3x5 block digits (rows of 3 bits each).
FONT: Dict[str, Tuple[str, ...]] = {
    "0": ("111", "101", "101", "101", "111"),
    "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"),
    "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"),
    "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"),
    "7": ("111", "001", "010", "100", "100"),
    "8": ("111", "101", "111", "101", "111"),
    "9": ("111", "101", "111", "001", "111"),
    "F": ("111", "100", "110", "100", "100"),
    "P": ("110", "101", "110", "100", "100"),
    "S": ("111", "100", "111", "001", "111"),
    ":": ("000", "010", "000", "010", "000"),
    ".": ("000", "000", "000", "000", "010"),
    " ": ("000", "000", "000", "000", "000"),
}


@functools.lru_cache(maxsize=64)
def text_mask(text: str, height: int, width: int) -> np.ndarray:
    """[H, W] float32 alpha mask with `text` rendered top-left, scaled like
    the reference (scale = clamp(H//60, 1, 8), reference depth.py:2070)."""
    scale = max(1, min(8, height // 60))
    char_h, char_w = 5 * scale, 3 * scale
    spacing = scale
    margin = 2 * scale
    mask = np.zeros((height, width), np.float32)
    for i, ch in enumerate(text):
        glyph = FONT.get(ch, FONT[" "])
        g = np.array([[1.0 if c == "1" else 0.0 for c in row] for row in glyph],
                     np.float32)
        g = np.repeat(np.repeat(g, scale, 0), scale, 1)
        x0 = margin + i * (char_w + spacing)
        y0 = margin
        x1, y1 = min(width, x0 + char_w), min(height, y0 + char_h)
        if x0 < width and y0 < height:
            mask[y0:y1, x0:x1] = np.maximum(mask[y0:y1, x0:x1],
                                            g[: y1 - y0, : x1 - x0])
    return mask


def overlay_text(rgb: torch.Tensor, mask: torch.Tensor,
                 color=(0.0, 255.0, 0.0)) -> torch.Tensor:
    """Blend a prepared text mask [H, W] over rgb [H,W,3] (values 0..255),
    keeping the input dtype; an integer frame is rounded as the JAX package
    rounds it (+0.5, clip to 0..255, truncate)."""
    alpha = mask[..., None].to(device=rgb.device, dtype=torch.float32)
    col = torch.tensor(color, dtype=torch.float32, device=rgb.device)
    out = rgb.float() * (1.0 - alpha) + col * alpha
    if not rgb.is_floating_point():
        out = (out + 0.5).clamp(0.0, 255.0)
    return out.to(rgb.dtype)


class FpsOverlay:
    """Throttled mask rebuild (every `interval` frames, reference
    depth.py:2060-2063) and the blend, on the device of the frame it is
    given; a numpy frame comes back as numpy."""

    def __init__(self, interval: int = 10):
        self.interval = interval
        self._frame = 0
        self._mask = None

    def __call__(self, rgb, fps: float):
        host = isinstance(rgb, np.ndarray)
        frame = torch.from_numpy(np.ascontiguousarray(rgb)) if host else rgb
        h, w = frame.shape[0], frame.shape[1]
        if (self._mask is None or self._frame % self.interval == 0
                or tuple(self._mask.shape) != (h, w) or self._mask.device != frame.device):
            self._mask = torch.from_numpy(text_mask(f"FPS: {fps:.1f}", h, w)).to(frame.device)
        self._frame += 1
        out = overlay_text(frame, self._mask)
        return out.numpy() if host else out
