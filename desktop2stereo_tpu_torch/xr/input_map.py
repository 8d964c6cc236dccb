"""XR ray → OS input mapping: cursor, clicks, drags, scroll, ownership.

Port of `desktop2stereo_tpu/xr/input_map.py`, copied: plain Python.

Host-side analog of the reference's input pipeline (reference
xr_viewer/input_handler.py:31-2046, input.py:1-580, constants.py:5-17):

- screen-UV → desktop-pixel mapping with edge snap: a ray slightly off the
  screen still drives the cursor, pulled to the nearest edge with strength
  EDGE_STRENGTH so the OS sees uninterrupted motion (input_handler.py:242-270);
- cursor ownership arbitration between the virtual keyboard and the screen
  with a distance hysteresis bias and a post-release grace period
  (constants.py:9-17);
- trigger → click/double-click/drag state machine;
- stick → discrete scroll ticks and arrow-key repeats via accumulators
  (input_handler.py scroll/arrow accumulators);
- two-trigger pinch → touch-zoom gesture deltas (the Windows touch-inject
  path's geometric core, input.py:121-390).

Everything is pure host math over abstract events; OS injection (SendInput,
uinput, CGEvent) is the attach-point for platform shims.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

# Snap strength of the cursor around the screen edge (reference
# constants.py:5): 0 = freeze at last on-screen point, 1 = hard clamp to
# the plane projection.
EDGE_STRENGTH = 0.6
# Keyboard-vs-screen ownership hysteresis (reference constants.py:9-17).
KB_CURSOR_PRIORITY_BIAS = 0.060   # metres
KB_CURSOR_RELEASE_GRACE = 0.12    # seconds

DOUBLE_CLICK_S = 0.35
DRAG_START_PX = 6.0


@dataclass(frozen=True)
class CursorSample:
    x: float
    y: float
    on_screen: bool   # ray actually on the bounded surface


class CursorMapper:
    """UV → desktop pixels with edge snap.

    Feed `update(hit_uv, plane_uv)` per frame: `hit_uv` is the bounded
    surface hit (None when the ray misses), `plane_uv` the unbounded plane
    UV (may be outside [0,1]).  While off-screen the cursor blends toward
    the clamped plane projection instead of freezing (reference
    input_handler.py:242-270)."""

    def __init__(self, width_px: int, height_px: int,
                 edge_strength: float = EDGE_STRENGTH):
        self.width_px = width_px
        self.height_px = height_px
        self.edge_strength = edge_strength
        self._last: Optional[Tuple[float, float]] = None

    def _to_px(self, u: float, v: float) -> Tuple[float, float]:
        # v=0 is the BOTTOM of the screen; desktop y grows downward.
        x = min(max(u, 0.0), 1.0) * (self.width_px - 1)
        y = (1.0 - min(max(v, 0.0), 1.0)) * (self.height_px - 1)
        return x, y

    def update(self, hit_uv: Optional[Tuple[float, float]],
               plane_uv: Optional[Tuple[float, float]]) -> Optional[CursorSample]:
        if hit_uv is not None:
            x, y = self._to_px(*hit_uv)
            self._last = (x, y)
            return CursorSample(x, y, True)
        if plane_uv is None or self._last is None:
            return None
        ex, ey = self._to_px(*plane_uv)  # clamped edge projection
        lx, ly = self._last
        s = self.edge_strength
        x, y = lx + (ex - lx) * s, ly + (ey - ly) * s
        self._last = (x, y)
        return CursorSample(x, y, False)

    def reset(self) -> None:
        self._last = None


@dataclass
class OwnershipArbiter:
    """Who owns the cursor: 'keyboard' or 'screen' (reference
    constants.py:9-17 + input_handler.py:60-71).  The keyboard keeps the
    cursor unless the screen hit is closer by more than the bias; after the
    keyboard releases, the screen stays suppressed for a grace period."""

    bias: float = KB_CURSOR_PRIORITY_BIAS
    grace_s: float = KB_CURSOR_RELEASE_GRACE
    _kb_owned: bool = False
    # far in the past: a fresh arbiter must not start inside the grace
    # window (callers pass their own monotonic clocks starting near 0)
    _kb_release_at: float = -1e9

    def decide(self, kb_dist: Optional[float], screen_dist: Optional[float],
               now: Optional[float] = None) -> Optional[str]:
        now = time.monotonic() if now is None else now
        if kb_dist is not None:
            if screen_dist is None or screen_dist > kb_dist - self.bias:
                self._kb_owned = True
                return "keyboard"
            # screen is decisively closer
            if self._kb_owned:
                self._kb_owned = False
                self._kb_release_at = now
            return "screen"
        if self._kb_owned:
            self._kb_owned = False
            self._kb_release_at = now
        if screen_dist is None:
            return None
        if now - self._kb_release_at < self.grace_s:
            return None  # suppression window after leaving the keys
        return "screen"


@dataclass(frozen=True)
class ClickEvent:
    kind: str          # "press" | "release" | "double" | "drag_start" | "drag"
    x: float
    y: float


class ClickDragTracker:
    """Trigger + cursor → click/double/drag events (reference
    input_handler.py trigger handling)."""

    def __init__(self, double_click_s: float = DOUBLE_CLICK_S,
                 drag_start_px: float = DRAG_START_PX):
        self.double_click_s = double_click_s
        self.drag_start_px = drag_start_px
        self._down = False
        self._down_pos = (0.0, 0.0)
        self._dragging = False
        self._was_double = False
        self._last_click_t = -1e9
        self._last_click_pos = (0.0, 0.0)

    def update(self, trigger: bool, x: float, y: float,
               now: Optional[float] = None) -> List[ClickEvent]:
        now = time.monotonic() if now is None else now
        events: List[ClickEvent] = []
        if trigger and not self._down:
            self._down = True
            self._down_pos = (x, y)
            self._dragging = False
            # "double" only when the previous gesture was a completed CLICK
            # (drags don't arm it — see release path) nearby in space.
            near = math.hypot(x - self._last_click_pos[0],
                              y - self._last_click_pos[1]) < 2 * self.drag_start_px
            self._was_double = near and now - self._last_click_t < self.double_click_s
            if self._was_double:
                events.append(ClickEvent("double", x, y))
            events.append(ClickEvent("press", x, y))
        elif trigger and self._down:
            dx = x - self._down_pos[0]
            dy = y - self._down_pos[1]
            if not self._dragging and math.hypot(dx, dy) >= self.drag_start_px:
                self._dragging = True
                events.append(ClickEvent("drag_start", *self._down_pos))
            if self._dragging:
                events.append(ClickEvent("drag", x, y))
        elif not trigger and self._down:
            self._down = False
            if not self._dragging and not self._was_double:
                # completed plain click: arms double-click detection.  Drags
                # and the double itself don't (no triple chaining).
                self._last_click_t = now
                self._last_click_pos = (x, y)
            else:
                self._last_click_t = -1e9
            self._dragging = False
            self._was_double = False
            events.append(ClickEvent("release", x, y))
        return events


class ScrollAccumulator:
    """Analog stick Y → discrete wheel ticks: integrate deflection (with a
    deadzone and speed curve) and emit whole ticks (reference
    input_handler.py scroll accumulator)."""

    def __init__(self, deadzone: float = 0.15, ticks_per_s: float = 18.0):
        self.deadzone = deadzone
        self.ticks_per_s = ticks_per_s
        self._acc = 0.0

    def update(self, stick_y: float, dt: float) -> int:
        mag = abs(stick_y)
        if mag < self.deadzone:
            self._acc = 0.0
            return 0
        # quadratic speed curve past the deadzone
        speed = ((mag - self.deadzone) / (1.0 - self.deadzone)) ** 2
        self._acc += math.copysign(speed * self.ticks_per_s * dt, stick_y)
        ticks = int(self._acc)
        self._acc -= ticks
        return ticks


class ArrowRepeater:
    """Stick X/Y → arrow-key events with initial delay + repeat rate
    (reference input_handler.py arrow accumulators)."""

    def __init__(self, deadzone: float = 0.5, initial_delay: float = 0.35,
                 repeat_s: float = 0.09):
        self.deadzone = deadzone
        self.initial_delay = initial_delay
        self.repeat_s = repeat_s
        self._dir: Optional[str] = None
        self._next_at = 0.0

    def update(self, stick_x: float, stick_y: float,
               now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        if abs(stick_x) < self.deadzone and abs(stick_y) < self.deadzone:
            self._dir = None
            return []
        if abs(stick_x) >= abs(stick_y):
            d = "Right" if stick_x > 0 else "Left"
        else:
            d = "Up" if stick_y > 0 else "Down"
        if d != self._dir:
            self._dir = d
            self._next_at = now + self.initial_delay
            return [d]
        if now >= self._next_at:
            self._next_at = now + self.repeat_s
            return [d]
        return []


@dataclass(frozen=True)
class PinchState:
    center: Tuple[float, float]
    distance: float
    scale: float       # vs pinch start
    translate: Tuple[float, float]


class PinchTracker:
    """Two-cursor pinch: scale + translation deltas for touch-zoom injection
    (geometric core of the reference's two-trigger pinch → Windows touch
    path, reference input.py:121-390)."""

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
        return PinchState(
            (cx, cy), dist, dist / sd, (cx - sx, cy - sy))
