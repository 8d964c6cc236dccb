"""Seeded capture feeds: the frame generators a traffic mix names, and the
source each feed hands the engine.

A mix file (`traffic/<mix>.json`) gives the engine ("batched" or
"single"), the feeds, the frame shape [H, W, 4] (BGRA), the capture rate,
the generator and the ring length.  Each feed cycles through a ring of
seeded frames; the engine's capture thread paces it at the mix's rate and
the engine keeps only the newest frame (latest wins), so the offered load
is fixed by the mix and not by the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose (`path`) of a run's seed."""
    return int(np.random.SeedSequence([seed % 2 ** 63, *path]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def desktop_frames(count: int, h: int, w: int, seed: int, layout: int = 0) -> List[np.ndarray]:
    """BGRA frames that look like a desktop: a flat wallpaper and taskbar,
    three windows with flat title bars and borders, and lines of text drawn
    from a seeded 64-glyph font (8x14 cells), light and dark themes; each
    frame moves the windows and scrolls their text.  The font and the text
    come from `seed`; the wallpaper and the windows' places, sizes, themes
    and motion from `layout` (a feed's index), so that feeds differ as
    desktops do while every seed gives each feed the same kind of screen."""
    rng = np.random.default_rng(seed)
    lay = np.random.default_rng([layout, 0x5EED])
    glyphs = (rng.random((64, 14, 8)) < 0.3)
    glyphs[:, :2] = glyphs[:, 12:] = glyphs[:, :, 7] = False  # line gap and letter gap
    glyphs[0] = False  # the space
    lines, cols = 60, 200
    text = rng.integers(1, 64, (lines + count * 2, cols))
    text[rng.random(text.shape) < 0.18] = 0
    themes = [((235, 235, 235), (30, 30, 30)), ((35, 30, 30), (200, 210, 210)),
              ((250, 250, 250), (60, 60, 60)), ((40, 44, 52), (171, 178, 191))]
    windows = []
    for _ in range(3):
        hh, ww = lay.uniform(0.3, 0.55), lay.uniform(0.3, 0.55)
        y, x = lay.uniform(0.0, 0.9 - hh), lay.uniform(0.0, 1.0 - ww)
        bg, fg = themes[lay.integers(len(themes))]
        bar = tuple(int(v) for v in lay.integers(40, 220, 3))
        motion = tuple(int(v) for v in lay.integers(-41, 42, 2))
        windows.append(((y, x, hh, ww), bg, fg, bar, motion))
    wallpaper = tuple(int(v) for v in lay.integers(20, 160, 3)) + (255,)
    frames = []
    for t in range(count):
        bgra = np.empty((h, w, 4), np.uint8)
        bgra[...] = wallpaper
        bgra[h - h // 27:] = (40, 40, 40, 255)  # taskbar
        for i, ((y, x, hh, ww), bg, fg, bar, (dy, dx)) in enumerate(windows):
            y0, x0 = int(y * h) + dy * t, int(x * w) + dx * t
            wh, ww = int(hh * h), int(ww * w)
            y0, x0 = min(max(y0, 0), h - wh - 1), min(max(x0, 0), w - ww - 1)
            bgra[y0:y0 + wh, x0:x0 + ww, :3] = (128, 128, 128)  # border
            bgra[y0 + 1:y0 + 31, x0 + 1:x0 + ww - 1, :3] = bar
            area = bgra[y0 + 31:y0 + wh - 1, x0 + 1:x0 + ww - 1, :3]
            area[...] = bg
            rows, cs = min(area.shape[0] // 14, lines), min(area.shape[1] // 8 - 2, cols)
            if rows <= 0 or cs <= 0:
                continue
            ink = glyphs[text[2 * t + i:2 * t + i + rows, :cs]]  # [rows, cs, 14, 8]
            ink = ink.transpose(0, 2, 1, 3).reshape(rows * 14, cs * 8)
            area[:rows * 14, 8:8 + cs * 8][ink] = fg
        frames.append(bgra)
    return frames


def synthetic_frames(count: int, h: int, w: int, seed: int, layout: int = 0) -> List[np.ndarray]:
    """BGRA frames: a moving smooth scene plus noise (`layout` unused)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(count):
        base = 128 + 90 * np.sin((xx + 40 * t) / 97.0) * np.cos(yy / 71.0)
        rgb = base[..., None] + np.array([0.0, 25.0, -25.0], np.float32)
        rgb = rgb + rng.normal(0, 10, (h, w, 3)).astype(np.float32)
        bgra = np.empty((h, w, 4), np.uint8)
        bgra[..., :3] = np.clip(rgb[..., ::-1], 0, 255)
        bgra[..., 3] = 255
        frames.append(bgra)
    return frames


GENERATORS: Dict[str, Callable[..., List[np.ndarray]]] = {
    "desktop": desktop_frames, "synthetic": synthetic_frames}


def feed_rings(mix: dict, seed: int) -> List[List[np.ndarray]]:
    """Each feed's ring of frames, from the run's seed."""
    h, w, c = mix["frame"]
    if c != 4:
        raise ValueError(f"frames are BGRA: the mix's frame shape must end in 4, got {c}")
    make = GENERATORS[mix["generator"]]
    return [make(mix["ring"], h, w, derive_seed(seed, 1, f), f) for f in range(mix["feeds"])]


class RingSource:
    """A capture source cycling through one feed's ring; never exhausted.
    It hands out the ring's own arrays (the engine copies them into its
    staging buffers and never writes them)."""

    def __init__(self, ring: List[np.ndarray]) -> None:
        self.ring = ring
        self.grabs = 0

    def grab(self) -> np.ndarray:
        frame = self.ring[self.grabs % len(self.ring)]
        self.grabs += 1
        return frame
