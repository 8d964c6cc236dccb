"""StereoWindow-compatible viewer facade for headless hosts.

Port of `desktop2stereo_tpu/sinks/viewer.py`.  The reference's local
presentation is a GLFW/OpenGL (or Metal) window with
`update_frame(rgb, depth, fps, latency)` / `render()` / key bindings
(reference viewer.py:1323-2933).  A GPU server has no display; this class keeps
the reference's API surface so orchestration code (and a future workstation
GL client) is source-compatible, while the actual presentation goes through
the MJPEG streamer — whose browser page plays the role of the window — and
the on-frame FPS overlay replaces the title-bar/OSD text.

Display-mode switching, fullscreen and aspect lock are settings-level
concerns here (the stereo arrangement happens in the device program); the
runtime keys the reference binds (1-9 mode switch, depth strength, edge
feather) map to the MJPEG server's /mode, /strength and /feather endpoints.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from desktop2stereo_tpu_torch.ops.overlay import FpsOverlay
from desktop2stereo_tpu_torch.sinks.mjpeg import MjpegSink


class StereoWindow:
    """Headless stand-in with the reference StereoWindow's surface
    (reference viewer.py:2359 update_frame, 2551 render)."""
    # engine skips the device->host depth fetch for sinks that never read it
    wants_depth = False


    def __init__(
        self,
        port: int = 1122,
        fps: float = 60.0,
        show_fps: bool = False,
        quality: int = 90,
        **_ignored,
    ) -> None:
        self._mjpeg = MjpegSink(port=port, fps=fps, quality=quality)
        self.show_fps = show_fps
        self._overlay = FpsOverlay()
        self._pending: Optional[np.ndarray] = None
        self._last_presented: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self.frame_count = 0

    # -- reference API ------------------------------------------------------

    def update_frame(self, rgb, depth=None, fps: float = 0.0,
                     latency: float = 0.0) -> None:
        """Accept the latest composed frame (device array or numpy)."""
        if self.show_fps and fps > 0:
            rgb = self._overlay(rgb, fps)
        with self._lock:
            self._pending = np.asarray(rgb)

    def render(self) -> None:
        """Present the pending frame (push to the MJPEG clients)."""
        with self._lock:
            frame, self._pending = self._pending, None
        if frame is not None:
            self._mjpeg.push(frame, None, None)
            with self._lock:
                self._last_presented = frame
            self.frame_count += 1

    def capture_glfw_image(self) -> Optional[np.ndarray]:
        """Last PRESENTED frame (the reference's readback path,
        viewer.py:2518) — already host-resident here.  Reads the presented
        slot, not the pending one: render() clears pending, so reading it
        would return None at every moment except mid-push."""
        with self._lock:
            return self._last_presented

    def should_close(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        self._closed.set()
        self._mjpeg.close()

    # -- sink protocol (so it can be used directly as an engine sink) --------

    def push(self, sbs_u8, depth, stats) -> None:
        fps = float(stats.get("fps", 0.0)) if isinstance(stats, dict) else 0.0
        self.update_frame(sbs_u8, depth, fps=fps)
        self.render()

    @property
    def url(self) -> str:
        return self._mjpeg.url

    @property
    def mode_switcher(self):
        return self._mjpeg.mode_switcher

    @mode_switcher.setter
    def mode_switcher(self, program) -> None:
        # the facade's "key bindings": GET /mode?set=… on the MJPEG server
        self._mjpeg.mode_switcher = program
