"""Per-frame laser/controller state → OS-input wire events.

Port of `desktop2stereo_tpu/xr/input_router.py`, copied: plain Python.

The client half of the reference's drive-the-desktop loop (reference
xr_viewer/input_handler.py:31-2046): composes the pure policy pieces from
xr/input_map.py (cursor edge snap, keyboard-vs-screen ownership, trigger
click/drag state machine, scroll/arrow accumulators, pinch) and
xr/keyboard.py (laser-typed key presses with modifier latching) into the
event dictionaries that travel over xr/net.py's input channel to the
capture host's injector (xr/injector.py InputBridge).

Event wire vocabulary (all little JSON dicts):
    {"t": "move", "u": 0..1, "v": 0..1}            cursor, image convention
    {"t": "button", "b": 1|2|3, "down": bool}      mouse buttons
    {"t": "scroll", "dy": ±n, "dx": ±n}            wheel ticks
    {"t": "tap", "vk": int, "mods": [vk...]}       one-shot key (vkbd/arrows)
    {"t": "touch", "id": n, "u":, "v":,
     "phase": "down"|"move"|"up"}                  two-trigger pinch contacts
                                                   (host injects uinput
                                                   multitouch, or synthesizes
                                                   ctrl+wheel zoom without it)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from desktop2stereo_tpu_torch.xr.input_map import (ArrowRepeater, ClickDragTracker,
                                             CursorMapper, OwnershipArbiter,
                                             ScrollAccumulator)
from desktop2stereo_tpu_torch.xr.keyboard import VK, Key, KeyboardState

TRIGGER_ON = 0.55
_MOVE_EPS_PX = 0.5
# UV band beyond the screen edge where an off-screen ray still drives the
# cursor via edge snap (reference input_handler.py:242-270: the cursor must
# not freeze the instant the ray slips off the bounded quad)
_EDGE_BAND_UV = 0.25
# pseudo screen-distance for edge-band plane hits: far enough that a real
# keyboard hover always outranks it in the ownership arbiter
_EDGE_BAND_DIST = 25.0
# NOTE r05: the router no longer synthesizes zoom ticks itself — the
# two-trigger pinch travels as REAL touch contacts ({"t": "touch"}) and the
# capture host decides: uinput multitouch when it can (parity with the
# reference's InjectTouchInput, input.py:121-390), ctrl+wheel synthesis
# when it can't (xr/injector.py PinchWheelZoom).


@dataclass
class HandInput:
    """One hand's sampled ray state for a tick."""

    screen_uv: Optional[Tuple[float, float]] = None   # bounded hit (u, v)
    plane_uv: Optional[Tuple[float, float]] = None    # unbounded plane uv
    screen_dist: Optional[float] = None               # ray t of screen hit
    kb_key: Optional[Key] = None                      # hovered key
    kb_dist: Optional[float] = None                   # ray t of keyboard hit
    trigger: float = 0.0


@dataclass
class RouterState:
    """Observable state for overlays/tests."""

    cursor_px: Optional[Tuple[float, float]] = None
    owner: Optional[str] = None
    pressed_vk: Optional[int] = None
    dragging: bool = False
    extra: Dict[str, float] = field(default_factory=dict)


class OsInputRouter:
    def __init__(self, frame_size: Tuple[int, int] = (1920, 1080),
                 keyboard_state: Optional[KeyboardState] = None):
        self.frame_w, self.frame_h = frame_size
        self.cursor = CursorMapper(self.frame_w, self.frame_h)
        self.arbiter = OwnershipArbiter()
        self.clicks = ClickDragTracker()
        self.scroll_v = ScrollAccumulator()
        self.scroll_h = ScrollAccumulator(ticks_per_s=12.0)
        self.arrows = ArrowRepeater()
        self.kb = keyboard_state or KeyboardState()
        self.state = RouterState()
        self._kb_trigger_prev = {"left": False, "right": False}
        self._last_sent_px: Optional[Tuple[float, float]] = None
        self._touch_pts: Dict[int, Tuple[float, float]] = {}

    def set_frame_size(self, w: int, h: int) -> None:
        if (w, h) != (self.frame_w, self.frame_h):
            self.frame_w, self.frame_h = w, h
            self.cursor = CursorMapper(w, h)
            self._last_sent_px = None

    # -- the tick -----------------------------------------------------------

    def update(self, hands: Dict[str, HandInput], *,
               scroll_xy: Tuple[float, float] = (0.0, 0.0),
               arrow_xy: Tuple[float, float] = (0.0, 0.0),
               dt: float = 1.0 / 72.0,
               now: Optional[float] = None) -> List[dict]:
        events: List[dict] = []
        st = self.state

        # keyboard typing: each hand's trigger rising edge on a hovered key
        # (reference input_handler.py laser typing)
        for hand, hi in hands.items():
            trig = hi.trigger >= TRIGGER_ON
            rising = trig and not self._kb_trigger_prev.get(hand, False)
            self._kb_trigger_prev[hand] = trig
            if rising and hi.kb_key is not None:
                out = self.kb.press(hi.kb_key)
                st.pressed_vk = hi.kb_key.vk
                if out is not None:
                    vk, mods = out
                    events.append({"t": "tap", "vk": vk, "mods": list(mods)})

        # cursor ownership: the closest interactive surface wins, keyboard
        # with a bias + release grace (reference constants.py:9-17)
        kb_dists = [hi.kb_dist for hi in hands.values()
                    if hi.kb_dist is not None]
        sc_dists = [hi.screen_dist for hi in hands.values()
                    if hi.screen_dist is not None]
        if not sc_dists:
            # edge snap: a ray just off the quad still owns the screen
            for hi in hands.values():
                if (hi.plane_uv is not None
                        and -_EDGE_BAND_UV <= hi.plane_uv[0] <= 1 + _EDGE_BAND_UV
                        and -_EDGE_BAND_UV <= hi.plane_uv[1] <= 1 + _EDGE_BAND_UV):
                    sc_dists.append(_EDGE_BAND_DIST)
                    break
        owner = self.arbiter.decide(
            min(kb_dists) if kb_dists else None,
            min(sc_dists) if sc_dists else None, now=now)
        st.owner = owner

        # mouse layer only while the screen owns the cursor.  Sorted hand
        # names keep the same hand on the same touch id across ticks.
        pinch_hands = [hi for _name, hi in sorted(hands.items())
                       if hi.screen_uv is not None
                       and hi.trigger >= TRIGGER_ON]
        if owner == "screen":
            # the pointing hand: trigger-pressed hand wins, else nearest hit
            cand = [(hi.trigger < TRIGGER_ON,
                     hi.screen_dist if hi.screen_dist is not None else 1e9,
                     i, hi)
                    for i, hi in enumerate(hands.values())
                    if hi.screen_uv is not None or hi.plane_uv is not None]
            if len(pinch_hands) >= 2:
                # two-trigger pinch → touch contacts on the wire, no
                # click/drag (the reference's two-trigger touch zoom,
                # reference input.py:121-390; the host's InputBridge
                # injects real multitouch or synthesizes ctrl+wheel).
                # Release a click the FIRST trigger may have pressed
                # before the second joined — otherwise the host drags
                # whatever is under the cursor for the whole pinch.
                for ev in self.clicks.update(False,
                                             *(st.cursor_px or (0, 0)),
                                             now=now):
                    if ev.kind == "release":
                        events.append({"t": "button", "b": 1,
                                       "down": False})
                st.dragging = False
                for tid, hi in enumerate(pinch_hands[:2]):
                    x, y = self._uv_px(hi.screen_uv)
                    uv = {"u": x / max(self.frame_w - 1, 1),
                          "v": y / max(self.frame_h - 1, 1)}
                    prev = self._touch_pts.get(tid)
                    if prev is None:
                        self._touch_pts[tid] = (x, y)
                        events.append({"t": "touch", "id": tid,
                                       "phase": "down", **uv})
                    elif (abs(x - prev[0]) >= _MOVE_EPS_PX
                          or abs(y - prev[1]) >= _MOVE_EPS_PX):
                        self._touch_pts[tid] = (x, y)
                        events.append({"t": "touch", "id": tid,
                                       "phase": "move", **uv})
            elif cand:
                cand.sort()
                hi = cand[0][3]
                sample = self.cursor.update(hi.screen_uv, hi.plane_uv)
                if sample is not None:
                    st.cursor_px = (sample.x, sample.y)
                    moved = (self._last_sent_px is None
                             or abs(sample.x - self._last_sent_px[0])
                             >= _MOVE_EPS_PX
                             or abs(sample.y - self._last_sent_px[1])
                             >= _MOVE_EPS_PX)
                    if moved:
                        self._last_sent_px = (sample.x, sample.y)
                        events.append({
                            "t": "move",
                            "u": sample.x / max(self.frame_w - 1, 1),
                            "v": sample.y / max(self.frame_h - 1, 1)})
                    trig = hi.trigger >= TRIGGER_ON
                    for ev in self.clicks.update(trig, sample.x, sample.y,
                                                 now=now):
                        if ev.kind == "press":
                            events.append({"t": "button", "b": 1,
                                           "down": True})
                        elif ev.kind == "release":
                            events.append({"t": "button", "b": 1,
                                           "down": False})
                        st.dragging = ev.kind in ("drag_start", "drag")
                if len(pinch_hands) < 2:
                    self._end_touch(events)
            else:
                # owner latched to "screen" (arbiter hysteresis) but no
                # hand currently reports a hit: without this, touch
                # contacts put down by a pinch would stay pressed on the
                # remote desktop (long-press side effects) until
                # ownership changed
                self._end_touch(events)
        else:
            # keyboard owns (or nothing): release any held drag cleanly
            for ev in self.clicks.update(False, *(st.cursor_px or (0, 0)),
                                         now=now):
                if ev.kind == "release":
                    events.append({"t": "button", "b": 1, "down": False})
            self._end_touch(events)

        # free-stick scroll / arrows (chord router grants ownership,
        # reference readme.md:219-224)
        dy = self.scroll_v.update(scroll_xy[1], dt)
        dx = self.scroll_h.update(scroll_xy[0], dt)
        if dy or dx:
            events.append({"t": "scroll", "dy": dy, "dx": dx})
        for name in self.arrows.update(arrow_xy[0], arrow_xy[1], now=now):
            events.append({"t": "tap", "vk": VK[name], "mods": []})

        return events

    def _end_touch(self, events: List[dict]) -> None:
        """Lift every active pinch contact (phase=up, ids ascending)."""
        for tid in sorted(self._touch_pts):
            events.append({"t": "touch", "id": tid, "phase": "up"})
        self._touch_pts.clear()

    def _uv_px(self, uv: Optional[Tuple[float, float]]):
        if uv is None:
            return None
        return (uv[0] * (self.frame_w - 1),
                (1.0 - uv[1]) * (self.frame_h - 1))
