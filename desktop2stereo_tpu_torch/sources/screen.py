"""Real screen capture behind the reference's `grab()` interface.

Port of `desktop2stereo_tpu/sources/screen.py`.  The reference dedicates
~1.5k LoC to per-OS capture backends (reference capture.py:
DXGI/WGC/ScreenCaptureKit/Quartz/mss).  On a Linux host the meaningful
paths, tried in order:

1. native X11 grab (C++ shim, desktop2stereo_tpu_torch.native.X11Capture — the
   DXGI-duplication counterpart), with
   - window-title mode: case-insensitive substring match, rect re-tracked
     every frame with 5px move hysteresis (reference capture.py:159-217),
   - XFixes cursor compositing (reference overlays the cursor manually on
     macOS and captures it via mss elsewhere, capture.py:864-1340, 1385);
2. mss, if installed (with_cursor where supported);
3. error with guidance (headless hosts should use --source shm with a
   remote capture agent, or synthetic/video).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# window re-target hysteresis in px (reference capture.py:159-217 uses 5)
MOVE_HYSTERESIS_PX = 5


def composite_cursor_bgra(frame: np.ndarray, cursor_argb: np.ndarray,
                          x: int, y: int) -> None:
    """Alpha-blend an ARGB cursor into a BGRA frame in place at (x, y)
    frame coordinates (top-left of the cursor image, hotspot already
    applied by the caller)."""
    fh, fw = frame.shape[:2]
    ch, cw = cursor_argb.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + cw, fw), min(y + ch, fh)
    if x0 >= x1 or y0 >= y1:
        return
    cur = cursor_argb[y0 - y : y1 - y, x0 - x : x1 - x]
    a = ((cur >> 24) & 0xFF).astype(np.float32)[..., None] / 255.0
    rgb = np.stack([cur & 0xFF, (cur >> 8) & 0xFF, (cur >> 16) & 0xFF],
                   axis=-1).astype(np.float32)  # B, G, R
    region = frame[y0:y1, x0:x1, :3].astype(np.float32)
    frame[y0:y1, x0:x1, :3] = (rgb * a + region * (1.0 - a)).astype(np.uint8)


class ScreenSource:
    def __init__(self, monitor_index: int = 0, max_frames: Optional[int] = None,
                 display: str = "", window_title: Optional[str] = None,
                 with_cursor: bool = True) -> None:
        self.max_frames = max_frames
        self.window_title = window_title
        self.with_cursor = with_cursor
        self._i = 0
        self._native = None
        self._sct = None
        self._mon = None
        self._last: Optional[np.ndarray] = None
        self._failures = 0
        self._window: int = 0
        self._window_lost = False
        self._rect: Optional[Tuple[int, int, int, int]] = None
        self._mon_rect: Optional[Tuple[int, int, int, int]] = None
        try:
            from desktop2stereo_tpu_torch.native import X11Capture

            self._native = X11Capture(display)
            if window_title:
                self._window = self._native.find_window(window_title)
                if not self._window:
                    raise RuntimeError(
                        f"no window matching {window_title!r} found")
                self._rect = self._native.window_rect(self._window)
            else:
                # per-monitor region of the root (reference
                # capture.py:_choose_monitor_and_rect).  Index 0 means the
                # FIRST monitor — same as the mss fallback and the
                # reference's index<=0 clamp (utils.py get_monitor_size) —
                # not the whole multi-monitor root; enumeration failure
                # falls back to the whole root (monitor_rect → None).
                from desktop2stereo_tpu_torch.core.display import monitor_rect

                self._mon_rect = monitor_rect(max(monitor_index, 0))
            return
        except Exception:
            if window_title:
                # window mode needs the native path regardless of whether
                # construction or window lookup failed — falling through to
                # mss would silently capture the WHOLE desktop instead
                raise
            self._native = None
        try:
            import mss

            self._sct = mss.mss(with_cursor=True) if with_cursor else mss.mss()
        except TypeError:  # older mss without with_cursor
            import mss

            self._sct = mss.mss()
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "no screen capture backend: no X11 display for the native "
                "shim and no 'mss' package; on a headless host use "
                "--source shm (remote capture agent) or synthetic/video"
            ) from e
        mons = self._sct.monitors
        self._mon = mons[min(monitor_index + 1, len(mons) - 1)]

    # transient-failure budget: reuse the last good frame for this many
    # consecutive misses before declaring the source dead (the reference
    # reuses its previous frame on grab failure, reference capture.py:228-236)
    MAX_CONSECUTIVE_FAILURES = 120

    def _track_window(self) -> Optional[Tuple[int, int, int, int]]:
        """Re-read the window rect; re-target only on moves > hysteresis or
        any resize (reference capture.py:159-217).  A lost window keeps
        being re-searched by title every frame and the stream FREEZES on
        the last captured frame meanwhile (returns None → grab() serves
        self._last within the failure budget) — window mode must never
        keep live-grabbing the stale desktop region, where whatever now
        occupies that area would leak into the stream."""
        rect = None
        if self._window:
            rect = self._native.window_rect(self._window)
        if rect is None:
            # window gone (or never found): try to re-find it by title (it
            # may have been recreated, e.g. an app restart)
            self._window = self._native.find_window(self.window_title or "")
            if self._window:
                rect = self._native.window_rect(self._window)
            if rect is None:
                if not self._window_lost:
                    print(f"[capture] window {self.window_title!r} lost; "
                          "freezing on the last frame while re-searching")
                self._window_lost = True
                return None
        if self._window_lost:
            print(f"[capture] window {self.window_title!r} re-acquired")
            self._window_lost = False
        if self._rect is not None:
            ox, oy, ow, oh = self._rect
            nx, ny, nw, nh = rect
            if (nw, nh) == (ow, oh) and abs(nx - ox) <= MOVE_HYSTERESIS_PX \
                    and abs(ny - oy) <= MOVE_HYSTERESIS_PX:
                return self._rect  # ignore sub-hysteresis jitter
        self._rect = rect
        return rect

    def _clamp_rect(self, rect):
        """Clamp a root-coordinate rect to the screen so the grab origin and
        the cursor-composite origin agree for partially offscreen windows."""
        sh, sw = self._native.size
        x, y, w, h = rect
        w = min(w, sw)
        h = min(h, sh)
        x = max(0, min(x, sw - w))
        y = max(0, min(y, sh - h))
        return x, y, w, h

    def _grab_native(self) -> Optional[np.ndarray]:
        # keyed on the MODE (a title was requested), not the current handle:
        # a lost window (handle 0) must keep returning the last rect / None,
        # never fall through to a whole-desktop grab
        if self.window_title:
            rect = self._track_window()
            if rect is None:
                return None
            rect = self._clamp_rect(rect)
            frame = self._native.grab_rect(*rect)
            origin = (rect[0], rect[1])
        elif self._mon_rect is not None:
            rect = self._clamp_rect(self._mon_rect)
            frame = self._native.grab_rect(*rect)
            origin = (rect[0], rect[1])
        else:
            frame = self._native.grab()
            origin = (0, 0)
        if frame is None:
            return None
        if self.with_cursor:
            frame = frame.copy()
            cur = self._native.cursor()
            if cur is not None:
                img, cx, cy = cur
                composite_cursor_bgra(frame, img,
                                      cx - origin[0], cy - origin[1])
            return frame
        return frame.copy()

    def grab(self) -> Optional[np.ndarray]:
        if self.max_frames is not None and self._i >= self.max_frames:
            return None
        self._i += 1
        if self._native is not None:
            frame = self._grab_native()
            if frame is None:
                if self._window_lost and self._last is not None:
                    # lost window: freeze indefinitely while re-searching by
                    # title — this is an awaiting-the-app state (it may be
                    # restarting), not a capture failure, so it does NOT
                    # burn the transient-failure budget
                    return self._last
                self._failures += 1
                if self._last is not None and \
                        self._failures <= self.MAX_CONSECUTIVE_FAILURES:
                    return self._last
                return None
            self._failures = 0
            self._last = frame
            return self._last
        try:
            shot = self._sct.grab(self._mon)
        except Exception:
            self._failures += 1
            if self._last is not None and \
                    self._failures <= self.MAX_CONSECUTIVE_FAILURES:
                return self._last
            return None
        self._failures = 0
        self._last = np.asarray(shot)  # BGRA uint8
        return self._last

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        if self._sct is not None:
            self._sct.close()



def list_windows() -> "list[str]":
    """Viewable top-level window titles for the control panel's capture
    dropdown (reference gui.py:376-470); [] on a host without a display.  A
    native library that fails to build raises."""
    from desktop2stereo_tpu_torch.native import X11Capture, load

    load()
    try:
        cap = X11Capture("")
    except RuntimeError:  # no X11 display
        return []
    try:
        return cap.list_windows()
    finally:
        cap.close()
