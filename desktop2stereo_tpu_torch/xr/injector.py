"""OS input injection: the capture-host half of the XR input loop.

Port of `desktop2stereo_tpu/xr/injector.py`.  The reference's headline
trick, driving the desktop from inside the headset, injects the laser
cursor, clicks, scroll and virtual-keyboard presses with
SendInput/InjectTouchInput on Windows (reference xr_viewer/input.py:121-390).
Here the capture host is a Linux X session, so the injector is XTest
(`native/d2s_native.cpp` `d2s_input_*`, dlopen'd libXtst), reached through
this shim:

- `XTestInjector`: real injection into the X display being captured;
- `UinputTouchInjector`: a virtual multitouch screen (`d2s_touch_*`);
- `RecordingInjector` / `RecordingTouchInjector`: in-memory doubles;
- `InputBridge`: decodes the wire events of `xr/net.py`'s input channel
  (normalized cursor uv, buttons, scroll ticks, VK key presses, touch
  contacts) into injector calls, with the VK→X-keysym table.

The port's native loader raises when the library cannot be built, where
the JAX loader returns None.  So a host without a display (or without
XTest, or without /dev/uinput) raises `InjectionUnavailable`, which
`make_injector` / `make_touch_injector` turn into None (the XR sink then
serves frames only, as the JAX sink does on a headless host), while a
failed build propagates.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from desktop2stereo_tpu_torch.native import load

# --------------------------------------------------------- VK → keysym ----

# X11 keysyms for the keyboard layer's Windows virtual-key codes
# (xr/keyboard.py VK table; the reference injects the same VKs natively).
_VK_KEYSYM: Dict[int, int] = {
    0x1B: 0xFF1B,  # Esc
    0x09: 0xFF09,  # Tab
    0x14: 0xFFE5,  # Caps → Caps_Lock
    0x10: 0xFFE1,  # Shift → Shift_L
    0x11: 0xFFE3,  # Ctrl → Control_L
    0x12: 0xFFE9,  # Alt → Alt_L
    0x5B: 0xFFEB,  # Win → Super_L
    0x5D: 0xFF67,  # Apps → Menu
    0x20: 0x0020,  # Space
    0x0D: 0xFF0D,  # Enter
    0x08: 0xFF08,  # Backspace
    0x2D: 0xFF63,  # Insert
    0x2E: 0xFFFF,  # Delete
    0x24: 0xFF50,  # Home
    0x23: 0xFF57,  # End
    0x21: 0xFF55,  # PgUp
    0x22: 0xFF56,  # PgDn
    0x2C: 0xFF61,  # PrtSc → Print
    0x91: 0xFF14,  # ScrLk
    0x13: 0xFF13,  # Pause
    0x26: 0xFF52,  # Up
    0x28: 0xFF54,  # Down
    0x25: 0xFF51,  # Left
    0x27: 0xFF53,  # Right
    # punctuation VKs → ASCII keysyms
    0xC0: 0x60, 0xBD: 0x2D, 0xBB: 0x3D, 0xDB: 0x5B, 0xDD: 0x5D,
    0xDC: 0x5C, 0xBA: 0x3B, 0xDE: 0x27, 0xBC: 0x2C, 0xBE: 0x2E, 0xBF: 0x2F,
}
for _i in range(10):                     # digits: VK == ASCII == keysym
    _VK_KEYSYM[0x30 + _i] = 0x30 + _i
for _c in range(ord("A"), ord("Z") + 1):  # letters: lowercase keysym
    _VK_KEYSYM[_c] = _c + 0x20
for _i in range(1, 13):                  # F1..F12
    _VK_KEYSYM[0x6F + _i] = 0xFFBD + _i


def vk_to_keysym(vk: int) -> Optional[int]:
    return _VK_KEYSYM.get(int(vk))


# ------------------------------------------------------------ injectors ---


class InjectionUnavailable(RuntimeError):
    """The host offers no display, no XTest or no /dev/uinput access."""


class XTestInjector:
    """Real X11 injection through the native library; raises
    InjectionUnavailable without a display or libXtst."""

    def __init__(self, display: str = ""):
        lib = load()
        self._lib = lib
        self._h = lib.d2s_input_open(display.encode())
        if not self._h:
            raise InjectionUnavailable("XTest input injection unavailable "
                                       "(no display or libXtst)")
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.d2s_input_screen_size(self._h, ctypes.byref(w), ctypes.byref(h))
        self.screen_size: Tuple[int, int] = (w.value, h.value)

    def move(self, x: int, y: int) -> None:
        self._lib.d2s_input_move(self._h, int(x), int(y))

    def button(self, button: int, down: bool) -> None:
        self._lib.d2s_input_button(self._h, int(button), int(down))

    def key_vk(self, vk: int, down: bool) -> None:
        ks = vk_to_keysym(vk)
        if ks is not None:
            self._lib.d2s_input_key(self._h, ks, int(down))

    def close(self) -> None:
        if self._h:
            self._lib.d2s_input_close(self._h)
            self._h = None


class UinputTouchInjector:
    """Real multitouch via a virtual uinput touchscreen (the Linux
    counterpart of the reference's InjectTouchInput, reference
    xr_viewer/input.py:121-390): apps that distinguish touch gestures from
    ctrl+wheel (maps, browsers, photo viewers) see genuine two-finger
    pinches.  Needs /dev/uinput write access; raises InjectionUnavailable
    when the host cannot provide it (the bridge then degrades to wheel
    zoom)."""

    def __init__(self, screen_size: Tuple[int, int] = (1920, 1080)):
        lib = load()
        self._lib = lib
        self._h = lib.d2s_touch_open(int(screen_size[0]), int(screen_size[1]))
        if not self._h:
            raise InjectionUnavailable("uinput touch unavailable "
                                       "(no /dev/uinput write access)")
        self.screen_size = (int(screen_size[0]), int(screen_size[1]))

    def touch(self, slot: int, x: int, y: int, down: bool) -> None:
        self._lib.d2s_touch_point(self._h, int(slot), int(x), int(y),
                                  int(down))

    def frame(self) -> None:
        self._lib.d2s_touch_frame(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.d2s_touch_close(self._h)
            self._h = None


class RecordingInjector:
    """Test double: records every call (the loopback e2e harness)."""

    def __init__(self, screen_size: Tuple[int, int] = (1920, 1080)):
        self.screen_size = screen_size
        self.events: List[tuple] = []

    def move(self, x: int, y: int) -> None:
        self.events.append(("move", int(x), int(y)))

    def button(self, button: int, down: bool) -> None:
        self.events.append(("button", int(button), bool(down)))

    def key_vk(self, vk: int, down: bool) -> None:
        self.events.append(("key", int(vk), bool(down)))

    def close(self) -> None:
        self.events.append(("close",))


class RecordingTouchInjector:
    """Test double for the touch path."""

    def __init__(self, screen_size: Tuple[int, int] = (1920, 1080)):
        self.screen_size = screen_size
        self.events: List[tuple] = []

    def touch(self, slot: int, x: int, y: int, down: bool) -> None:
        self.events.append(("touch", int(slot), int(x), int(y), bool(down)))

    def frame(self) -> None:
        self.events.append(("frame",))

    def close(self) -> None:
        self.events.append(("close",))


def make_injector(display: str = "") -> Optional[XTestInjector]:
    """XTest injector if the host can inject, else None (a headless host
    serves frames but cannot click; the sink's url says input is inert).  A
    native library that fails to build raises."""
    try:
        return XTestInjector(display)
    except InjectionUnavailable:
        return None


def make_touch_injector(
        screen_size: Tuple[int, int] = (1920, 1080)
) -> Optional[UinputTouchInjector]:
    """uinput touchscreen if the host grants /dev/uinput, else None (the
    bridge synthesizes ctrl+wheel zoom from the same touch stream)."""
    try:
        return UinputTouchInjector(screen_size)
    except InjectionUnavailable:
        return None


# --------------------------------------------------------------- bridge ---

# X11 wheel buttons: 4 up, 5 down, 6 left, 7 right.  Tuples are
# (button-for-positive-ticks, button-for-negative): positive dy = scroll up
# (stick forward), positive dx = scroll right.
_WHEEL_V = (4, 5)
_WHEEL_H = (7, 6)


@dataclass(frozen=True)
class PinchState:
    center: Tuple[float, float]
    distance: float
    scale: float                    # distance / distance at pinch start
    translate: Tuple[float, float]  # center - center at pinch start


class PinchTracker:
    """Two-contact pinch: scale and translation since the pinch began (the
    JAX package's `xr/input_map.py` PinchTracker, copied: the geometric core
    of the reference's two-trigger pinch, reference input.py:121-390)."""

    def __init__(self):
        self._start: Optional[Tuple[Tuple[float, float], float]] = None

    def update(self, p1: Optional[Tuple[float, float]],
               p2: Optional[Tuple[float, float]]) -> Optional[PinchState]:
        if p1 is None or p2 is None:
            self._start = None
            return None
        cx = (p1[0] + p2[0]) / 2.0
        cy = (p1[1] + p2[1]) / 2.0
        dist = math.hypot(p1[0] - p2[0], p1[1] - p2[1])
        if self._start is None:
            self._start = ((cx, cy), max(dist, 1e-6))
            return PinchState((cx, cy), dist, 1.0, (0.0, 0.0))
        (sx, sy), sd = self._start
        return PinchState((cx, cy), dist, dist / sd, (cx - sx, cy - sy))


class PinchWheelZoom:
    """Host-side fallback for touch streams on hosts without uinput:
    re-derives the pinch scale from the two contacts and synthesizes the
    ctrl+wheel zoom ticks the router used to send directly (the Linux
    analog of the reference's touch zoom, reference input.py:121-390).
    PinchTracker holds the geometry; this class only converts its
    cumulative scale into discrete wheel ticks."""

    TICK_SCALE = 0.08  # log-scale units per wheel tick

    def __init__(self):
        self._pts: Dict[int, Tuple[float, float]] = {}
        self._tracker = PinchTracker()
        self._emitted = 0.0  # log-scale already converted to ticks

    def feed(self, ev: dict, inj, screen: Tuple[int, int]) -> None:
        w, h = screen
        tid = int(ev.get("id", 0))
        phase = ev.get("phase")
        if phase == "up":
            self._pts.pop(tid, None)
            self._tracker.update(None, None)
            self._emitted = 0.0
            return
        self._pts[tid] = (float(ev.get("u", 0.0)) * max(w - 1, 1),
                          float(ev.get("v", 0.0)) * max(h - 1, 1))
        if len(self._pts) < 2:
            return
        p1, p2 = list(self._pts.values())[:2]
        state = self._tracker.update(p1, p2)
        if state is None:
            return
        total = math.log(max(state.scale, 1e-6))
        ticks = int((total - self._emitted) / self.TICK_SCALE)
        if ticks:
            self._emitted += ticks * self.TICK_SCALE
            inj.key_vk(0x11, True)               # Ctrl
            btn = 4 if ticks > 0 else 5          # wheel up/down
            for _ in range(abs(ticks)):
                inj.button(btn, True)
                inj.button(btn, False)
            inj.key_vk(0x11, False)


class InputBridge:
    """Wire events (xr/net.py input channel) → injector calls.

    Cursor positions travel as normalized (u, v) in IMAGE convention
    (v=0 top) of the captured frame, so resolution changes on either side
    never skew the mapping; the bridge scales to the injector's screen.

    Touch streams ({"t": "touch", ...} from the router's two-trigger
    pinch) go to the uinput touchscreen when the host has one; otherwise
    they collapse to ctrl+wheel zoom via PinchWheelZoom — the capability
    decision lives HERE, on the host that knows, not in the headset."""

    def __init__(self, injector, screen_size: Optional[Tuple[int, int]] = None,
                 touch_injector=None):
        self.injector = injector
        self.touch_injector = touch_injector
        self.screen_size = screen_size or getattr(
            injector, "screen_size", (1920, 1080))
        self.events_handled = 0
        self._pinch_fallback = PinchWheelZoom()

    def handle(self, events: List[dict]) -> None:
        inj = self.injector
        if inj is None and self.touch_injector is None:
            return
        w, h = self.screen_size
        touched = False
        for ev in events:
            t = ev.get("t")
            if t == "touch":
                tj = self.touch_injector
                if tj is not None:
                    x = float(ev.get("u", 0.0)) * max(w - 1, 1)
                    y = float(ev.get("v", 0.0)) * max(h - 1, 1)
                    tj.touch(int(ev.get("id", 0)) % 10, int(round(x)),
                             int(round(y)), ev.get("phase") != "up")
                    touched = True
                elif inj is not None:
                    self._pinch_fallback.feed(ev, inj, (w, h))
                self.events_handled += 1
                continue
            if inj is None:
                continue
            if t == "move":
                x = float(ev.get("u", 0.0)) * max(w - 1, 1)
                y = float(ev.get("v", 0.0)) * max(h - 1, 1)
                inj.move(int(round(x)), int(round(y)))
            elif t == "button":
                inj.button(int(ev.get("b", 1)), bool(ev.get("down")))
            elif t == "scroll":
                for ticks, (bpos, bneg) in ((int(ev.get("dy", 0)), _WHEEL_V),
                                            (int(ev.get("dx", 0)), _WHEEL_H)):
                    btn = bpos if ticks > 0 else bneg
                    for _ in range(abs(ticks)):
                        inj.button(btn, True)
                        inj.button(btn, False)
            elif t == "key":
                mods = ev.get("mods") or ()
                down = bool(ev.get("down", True))
                vk = int(ev.get("vk", 0))
                if down:
                    for m in mods:
                        inj.key_vk(int(m), True)
                    inj.key_vk(vk, True)
                else:
                    inj.key_vk(vk, False)
                    for m in reversed(list(mods)):
                        inj.key_vk(int(m), False)
            elif t == "tap":
                # one-shot key press+release with latched modifiers (the
                # virtual keyboard's output, xr/keyboard.py press())
                mods = [int(m) for m in (ev.get("mods") or ())]
                vk = int(ev.get("vk", 0))
                for m in mods:
                    inj.key_vk(m, True)
                inj.key_vk(vk, True)
                inj.key_vk(vk, False)
                for m in reversed(mods):
                    inj.key_vk(m, False)
            self.events_handled += 1
        if touched:
            # one SYN_REPORT per wire batch: contacts that moved together
            # land in the same input frame (multitouch is frame-oriented)
            self.touch_injector.frame()
