"""Local window sink: on-host presentation of the composed stereo frames.

Port of `desktop2stereo_tpu/sinks/window.py`; cv2 is imported when the sink
is made.  The reference's primary output is a GLFW/moderngl window with
hot-keys and a stats title bar (reference viewer.py:1323-2933,
main.py:1233-1251).  Here the heavy lifting (DIBR, display-mode
composition) already happened on the card, so the window's only job is to blit frames — an OpenCV HighGUI
window does that everywhere a display exists, with the reference's title-bar
stats and the basic key set:

    q / ESC       quit (stops the whole pipeline via the engine's error path)
    f / Enter / Space  toggle fullscreen (reference Enter/Space,
              readme.md:367-375)
    s         save a screenshot PNG next to the working dir
    m / Tab / 1-9  cycle / select the display mode live (the reference's
              viewer hot-keys, reference viewer.py:2304; the pipeline
              re-targets a lazily-compiled program variant at the next frame)
    ↑ / ↓ / + / - / 0  step / reset the live depth strength (reference
              UP/DOWN/0, viewer.py:2321-2329; +/- kept as aliases for
              terminals whose HighGUI build eats arrow codes)
    ← / →     move the window to the previous / next monitor (reference
              LEFT/RIGHT, readme.md:374-375; xrandr monitor rects)
    b         toggle per-eye edge feathering (reference KEY_B)
    d         in Depth mode, flip between the depth map and the original
              RGB (reference KEY_D, viewer.py:2310-2314)
    a         toggle fill-16:9 letterboxing of the presented frame
              (reference KEY_A, viewer.py:2340-2343)
    l         toggle the viewer aspect-ratio lock live (reference KEY_L,
              viewer.py:2344-2347)

The reference's KEY_M mouse pass-through (click-through window) is a
compositor capability HighGUI does not expose — that toggle lives at the
host-shim boundary with the other OS-input injection (xr/input_map.py's
SendInput analog).

Headless hosts keep using the MJPEG viewer facade (sinks/viewer.py).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np


class WindowCloseRequested(Exception):
    """Raised out of push() so FrameEngine's error propagation performs the
    shutdown (the reference's window_should_close loop, main.py:1194)."""


# Extended key codes as returned by cv.waitKeyEx: GTK/X11 keysyms and
# Windows VK codes (HighGUI passes whichever the platform backend emits).
_KEYS_LEFT = frozenset({65361, 2424832})
_KEYS_UP = frozenset({65362, 2490368})
_KEYS_RIGHT = frozenset({65363, 2555904})
_KEYS_DOWN = frozenset({65364, 2621440})
_KEYS_ENTER = frozenset({10, 13, 65293, 65421})  # LF/CR, GTK Return/KP_Enter


class WindowSink:
    # engine skips the device->host depth fetch for sinks that never read it
    wants_depth = False

    def __init__(self, title: str = "desktop2stereo",
                 screenshot_dir: str = ".", keep_aspect: bool = False,
                 fill_16_9: bool = False):
        import cv2  # hard dependency for this sink; cli surfaces the error

        if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
                or os.name == "nt"):
            raise RuntimeError(
                "no display available for the window sink; use --sink mjpeg")
        self._cv = cv2
        self.title = title
        # the settings 'Fix Viewer Aspect' knob (reference utils.py:902):
        # a resized window letterboxes instead of stretching
        self.keep_aspect = keep_aspect
        # the settings 'Fill 16:9' knob (reference viewer.py:1346): pad the
        # presented frame to a 16:9 canvas instead of showing it bare
        self.fill_16_9 = fill_16_9
        self.screenshot_dir = screenshot_dir
        self._fullscreen = False
        self._created = False
        self._last_title = 0.0
        self.frames = 0
        # set by the CLI to the live ProgramCache: enables the m/1-9 keys
        self.mode_switcher = None
        # KEY_D state: we temporarily swapped Depth → Mono to show the RGB
        self._show_rgb_in_depth = False

    def _ensure_window(self) -> None:
        if not self._created:
            flags = self._cv.WINDOW_NORMAL
            if self.keep_aspect:
                flags |= getattr(self._cv, "WINDOW_KEEPRATIO", 0)
            self._cv.namedWindow(self.title, flags)
            self._created = True

    @staticmethod
    def _pad_to_16_9(img: np.ndarray) -> np.ndarray:
        """Letterbox/pillarbox the frame into a 16:9 canvas (the reference
        viewer's fill-16:9 viewport fit, viewer.py:1760-1770)."""
        h, w = img.shape[:2]
        if w * 9 == h * 16:
            return img
        if w * 9 < h * 16:  # too narrow → pillarbox to width
            new_w = -(-h * 16 // 9)
            canvas = np.zeros((h, new_w) + img.shape[2:], img.dtype)
            x0 = (new_w - w) // 2
            canvas[:, x0:x0 + w] = img
        else:  # too wide → letterbox to height
            new_h = -(-w * 9 // 16)
            canvas = np.zeros((new_h, w) + img.shape[2:], img.dtype)
            y0 = (new_h - h) // 2
            canvas[y0:y0 + h] = img
        return canvas

    def _move_to_adjacent_monitor(self, step: int) -> None:
        """Reference LEFT/RIGHT keys: relocate the viewer window to the
        previous/next monitor (readme.md:374-375 — the reference calls
        glfwSetWindowMonitor on the adjacent GLFW monitor).  Here: xrandr
        monitor rects + cv.moveWindow; fullscreen is re-applied on the
        target monitor."""
        from desktop2stereo_tpu_torch.core.display import list_monitors

        mons = list_monitors()
        if len(mons) < 2 or not self._created:
            return
        cur = 0
        try:
            x, y = self._cv.getWindowImageRect(self.title)[:2]
            for i, (_n, mx, my, mw, mh) in enumerate(mons):
                if mx <= x < mx + mw and my <= y < my + mh:
                    cur = i
                    break
        except Exception:
            pass
        name, mx, my, _mw, _mh = mons[(cur + step) % len(mons)]
        cv = self._cv
        was_fullscreen = self._fullscreen
        if was_fullscreen:  # un-fullscreen so moveWindow lands on the target
            cv.setWindowProperty(self.title, cv.WND_PROP_FULLSCREEN,
                                 cv.WINDOW_NORMAL)
        cv.moveWindow(self.title, mx + 32, my + 32)
        if was_fullscreen:
            cv.setWindowProperty(self.title, cv.WND_PROP_FULLSCREEN,
                                 cv.WINDOW_FULLSCREEN)
        print(f"[window] moved to monitor {name}")

    def push(self, sbs_u8: np.ndarray, depth: Optional[np.ndarray],
             stats: dict) -> None:
        cv = self._cv
        self._ensure_window()
        shown = sbs_u8[..., ::-1]  # RGB → BGR
        if self.fill_16_9:
            shown = self._pad_to_16_9(shown)
        cv.imshow(self.title, shown)
        now = time.monotonic()
        if now - self._last_title > 0.5 and stats:
            # the reference's title-bar stats (main.py:1233-1251)
            fps = stats.get("fps", 0.0)
            low = stats.get("fps_1pct_low", 0.0)
            dropped = stats.get("dropped", 0)
            cv.setWindowTitle(
                self.title,
                f"{self.title}  {fps:.1f} FPS (1% low {low:.1f}, "
                f"dropped {dropped})")
            self._last_title = now
        self.frames += 1
        # waitKeyEx sees arrow/function keysyms that the classic
        # `waitKey & 0xFF` mask destroys; ASCII keys come through unchanged
        raw = int(getattr(cv, "waitKeyEx", cv.waitKey)(1))
        key = raw & 0xFF if 0 <= raw < 256 else raw
        if key in (27, ord("q")):
            raise WindowCloseRequested("window closed by user")
        if key in (ord("f"), ord(" ")) or raw in _KEYS_ENTER:
            self._fullscreen = not self._fullscreen
            cv.setWindowProperty(
                self.title, cv.WND_PROP_FULLSCREEN,
                cv.WINDOW_FULLSCREEN if self._fullscreen else cv.WINDOW_NORMAL)
        elif raw in _KEYS_LEFT or raw in _KEYS_RIGHT:
            # reference LEFT/RIGHT: move the window to the adjacent monitor
            self._move_to_adjacent_monitor(+1 if raw in _KEYS_RIGHT else -1)
        elif key == ord("s"):
            path = os.path.join(self.screenshot_dir,
                                f"d2s_screenshot_{int(time.time())}.png")
            cv.imwrite(path, sbs_u8[..., ::-1])
            print(f"[window] saved {path}")
        elif key == ord("a"):
            # the reference viewer's KEY_A fill-16:9 toggle (viewer.py:2340)
            self.fill_16_9 = not self.fill_16_9
            print(f"[window] fill 16:9: {'ON' if self.fill_16_9 else 'OFF'}")
        elif key == ord("l"):
            # the reference viewer's KEY_L aspect-lock toggle
            # (viewer.py:2344); HighGUI window flags are creation-time, so
            # re-create the window with the new flag at the next frame
            self.keep_aspect = not self.keep_aspect
            if self._created:
                try:
                    cv.destroyWindow(self.title)
                except Exception:
                    pass
                self._created = False
                self._fullscreen = False
            print(f"[window] aspect lock: "
                  f"{'ON' if self.keep_aspect else 'OFF'}")
        elif self.mode_switcher is not None:
            if key in (ord("m"), 9):  # 9 = Tab, the reference's cycle key
                self._show_rgb_in_depth = False
                print(f"[window] display mode → "
                      f"{self.mode_switcher.cycle_display_mode()}")
            elif ord("1") <= key <= ord("9"):
                from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES

                idx = key - ord("1")
                if idx < len(DISPLAY_MODES):
                    self._show_rgb_in_depth = False
                    self.mode_switcher.set_display_mode(DISPLAY_MODES[idx])
                    print(f"[window] display mode → {DISPLAY_MODES[idx]}")
            elif key == ord("d"):
                # the reference viewer's KEY_D: in Depth Map mode, flip
                # between the depth map and the original RGB
                # (viewer.py:2310-2314); here the flip re-targets the Mono
                # program variant and back
                mode_now = getattr(self.mode_switcher, "display_mode", None)
                if self._show_rgb_in_depth:
                    self._show_rgb_in_depth = False
                    # only restore if nothing else (another sink's /mode
                    # endpoint, a tee'd window) changed the mode meanwhile
                    if mode_now == "Mono":
                        self.mode_switcher.set_display_mode("Depth")
                        print("[window] depth map mode: showing depth map")
                elif mode_now == "Depth":
                    self._show_rgb_in_depth = True
                    self.mode_switcher.set_display_mode("Mono")
                    print("[window] depth map mode: showing original RGB")
            # live depth strength (the reference viewer's UP/DOWN/0 keys,
            # reference viewer.py:2321-2329; +/- here — cv2's waitKey
            # cannot see arrow keys through the 0xFF mask)
            elif (key in (ord("+"), ord("=")) or raw in _KEYS_UP) and hasattr(
                    self.mode_switcher, "adjust_depth_strength"):
                v = self.mode_switcher.adjust_depth_strength(+0.5)
                print(f"[window] depth strength → {v:.1f}")
            elif (key == ord("-") or raw in _KEYS_DOWN) and hasattr(
                    self.mode_switcher, "adjust_depth_strength"):
                v = self.mode_switcher.adjust_depth_strength(-0.5)
                print(f"[window] depth strength → {v:.1f}")
            elif key == ord("0") and hasattr(
                    self.mode_switcher, "reset_depth_strength"):
                v = self.mode_switcher.reset_depth_strength()
                print(f"[window] depth strength reset → {v:.1f}")
            elif key == ord("b") and hasattr(
                    self.mode_switcher, "toggle_feather"):
                # the reference viewer's KEY_B (viewer.py:2338-2339)
                on = self.mode_switcher.toggle_feather()
                print(f"[window] edge feathering: {'ON' if on else 'OFF'}")

    def close(self) -> None:
        if self._created:
            try:
                self._cv.destroyWindow(self.title)
            except Exception:
                pass
            self._created = False
