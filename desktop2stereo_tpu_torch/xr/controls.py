"""Controller chord policy: per-tick controller state → semantic actions.

Port of `desktop2stereo_tpu/xr/controls.py`, copied: plain Python.

The reference's in-headset control surface is a large table of button/stick
combinations (reference readme.md:193-244, implemented across
xr_viewer/input_handler.py:960-1330): grip-gated stick axes re-target from
mouse scroll to screen geometry to depth knobs, buttons discriminate
short/long presses, and several maintenance combos fire after a hold
threshold.  This module is that policy layer, redesigned as a pure
deterministic state machine:

- it owns NO OpenXR calls, poses, or side effects — callers sample their
  runtime into a `ControllerState` each tick and receive `Action` events;
- every reference gesture is a named `Action.kind` so presenters
  (tools/xr_client.py --present openxr), tests, and future host shims bind
  behavior in one place;
- thresholds match the reference's: stick-button/Y-button long press 1.0 s
  (input_handler.py:966-970), X-button tiers <1 s tap / ≥1 s release /
  ≥4 s hold (readme.md:209-211), calibration combo 1.0 s
  (input_handler.py:1003-1016), brand switch 0.5 s
  (input_handler.py:1039-1055), crop: trigger ≥0.5 pressed, 3.0 s hold to
  cycle, 0.5 s double-tap window (input_handler.py:1070-1118), stick
  deadzone 0.15 (input_handler.py:1022-1027).

Continuous-axis routing (the reference applies stick values every frame):
axis actions carry the live stick value; the caller integrates (the
reference multiplies by per-frame step constants).  Mouse scroll / arrow
repeat stay in xr/input_map.py's accumulators — this router only decides
WHICH consumer owns the stick this tick.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

DEADZONE = 0.15
LONG_PRESS_S = 1.0
BOTH_STICKS_S = 0.5
X_GLOW_S = 1.0
X_PASSTHROUGH_S = 4.0
CALIB_COMBO_S = 1.0
BRAND_COMBO_S = 0.5
SEAT_ADJUST_S = 3.0
CROP_HOLD_S = 3.0
CROP_PRESS_THRESH = 0.5
CROP_DCLICK_S = 0.5


@dataclass
class ControllerState:
    """One tick's sampled controller state (both hands)."""

    grip_l: bool = False
    grip_r: bool = False
    stick_l: Tuple[float, float] = (0.0, 0.0)   # x, y in [-1, 1]
    stick_r: Tuple[float, float] = (0.0, 0.0)
    stick_btn_l: bool = False
    stick_btn_r: bool = False
    btn_a: bool = False        # right hand
    btn_b: bool = False        # right hand
    btn_x: bool = False        # left hand
    btn_y: bool = False        # left hand
    btn_menu: bool = False     # left hand
    trigger_l: float = 0.0
    trigger_r: float = 0.0
    laser_l_on_screen: bool = False
    laser_r_on_screen: bool = False
    keyboard_hover_l: bool = False
    keyboard_hover_r: bool = False


@dataclass
class Action:
    kind: str
    value: float = 0.0
    hand: str = ""


class _PressTimer:
    """Short/long press discrimination for one button.

    Emits ("short",) on release before `long_s`; emits ("long",) exactly
    once — at the hold threshold when `fire_at_threshold` (the reference's
    X-passthrough / combo style) else on release (the reference's
    X-glow style)."""

    def __init__(self, long_s: float = LONG_PRESS_S,
                 fire_at_threshold: bool = True):
        self.long_s = long_s
        self.fire_at_threshold = fire_at_threshold
        self._t0: Optional[float] = None
        self._fired = False

    def update(self, down: bool, now: float) -> Optional[str]:
        if down:
            if self._t0 is None:
                self._t0 = now
                self._fired = False
            elif (self.fire_at_threshold and not self._fired
                    and now - self._t0 >= self.long_s):
                self._fired = True
                return "long"
            return None
        # release
        if self._t0 is None:
            return None
        held = now - self._t0
        self._t0 = None
        if self._fired:
            self._fired = False
            return None
        if held >= self.long_s:
            return "long" if not self.fire_at_threshold else None
        return "short"


class _TieredPress:
    """The reference X button: tap <1 s → A, release ≥1 s → B, hold ≥4 s →
    C fired at threshold (readme.md:209-211)."""

    def __init__(self, mid_s: float = X_GLOW_S, top_s: float = X_PASSTHROUGH_S):
        self.mid_s = mid_s
        self.top_s = top_s
        self._t0: Optional[float] = None
        self._top_fired = False

    def update(self, down: bool, now: float) -> Optional[str]:
        if down:
            if self._t0 is None:
                self._t0 = now
                self._top_fired = False
            elif not self._top_fired and now - self._t0 >= self.top_s:
                self._top_fired = True
                return "top"
            return None
        if self._t0 is None:
            return None
        held = now - self._t0
        top_fired = self._top_fired
        self._t0 = None
        self._top_fired = False
        if top_fired:
            return None
        return "mid" if held >= self.mid_s else "tap"


class _ComboHold:
    """Fire once when a predicate has held true for `hold_s` (the
    reference's calibration / brand-switch / seat-adjust / crop-cycle
    combos, input_handler.py:1003-1016,1039-1055,1132-1143)."""

    def __init__(self, hold_s: float):
        self.hold_s = hold_s
        self._t0: Optional[float] = None
        self._fired = False

    def update(self, active: bool, now: float) -> bool:
        if not active:
            self._t0 = None
            self._fired = False
            return False
        if self._t0 is None:
            self._t0 = now
        if not self._fired and now - self._t0 >= self.hold_s:
            self._fired = True
            return True
        return False


class _DoubleTap:
    """Release-to-release double-tap window (crop-adjust toggle,
    input_handler.py:1108-1118)."""

    def __init__(self, window_s: float = CROP_DCLICK_S):
        self.window_s = window_s
        self._last_release = -1e9

    def on_release(self, now: float) -> bool:
        if now - self._last_release <= self.window_s:
            self._last_release = -1e9
            return True
        self._last_release = now
        return False


def _live(v: float) -> bool:
    return abs(v) > DEADZONE


class ChordRouter:
    """The full reference combination table as a deterministic router.

    Call `update(state, now=None)` once per tick; integrate the returned
    axis actions with your own step constants (the reference's per-frame
    steps live beside its renderer; ours live beside ScreenPose /
    ProgramCache knobs in the presenter)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.crop_mode = "auto"            # auto → manual → off (reference order)
        self.crop_adjust_active = False
        self.calibration_mode = False
        self.seat_adjust_active = False
        self._y_btn = _PressTimer(fire_at_threshold=True)       # long = cycle presets
        self._menu_btn = _PressTimer(fire_at_threshold=True)    # long = reset depth ratio
        self._stick_btn_l = _PressTimer(fire_at_threshold=True)  # long = help panel
        self._stick_btn_r = _PressTimer(fire_at_threshold=True)  # long = reset orientation
        self._x_btn = _TieredPress()
        self._calib_combo = _ComboHold(CALIB_COMBO_S)
        self._brand_combo = _ComboHold(BRAND_COMBO_S)
        self._seat_combo = _ComboHold(SEAT_ADJUST_S)
        self._crop_hold = _ComboHold(CROP_HOLD_S)
        self._crop_tap = _DoubleTap()
        self._both_sticks = _ComboHold(BOTH_STICKS_S)
        self._a_tap = _DoubleTap()
        self._ltrig_prev = False
        self._crop_fired_press = False
        self._a_prev = False
        self._b_prev = False
        # per-hand grip target latch: "only grip one item at a time" —
        # decided when the grip closes by what the laser is hitting,
        # keyboard taking priority, and held until release
        # (input_handler.py:1146-1160)
        self._grip_target = {"left": None, "right": None}

    # -- helpers ----------------------------------------------------------

    def _emit_axis(self, out: List[Action], kind: str, v: float,
                   hand: str = "") -> None:
        if _live(v):
            out.append(Action(kind, v, hand))

    # -- main tick --------------------------------------------------------

    def update(self, s: ControllerState,
               now: Optional[float] = None) -> List[Action]:
        now = self._clock() if now is None else now
        out: List[Action] = []
        lx, ly = s.stick_l
        rx, ry = s.stick_r

        # Maintenance combos run before anything else (they suppress the
        # normal meaning of their member buttons, input_handler.py:1003-1016)
        if self._calib_combo.update(s.btn_menu and s.btn_a and s.btn_b, now):
            self.calibration_mode = not self.calibration_mode
            out.append(Action("calibration_mode", float(self.calibration_mode)))
        if self.calibration_mode:
            # sticks adjust calibration only; B saves and exits (rising edge)
            self._emit_axis(out, "calib_offset_y", ly)
            self._emit_axis(out, "calib_offset_z", ry)
            self._emit_axis(out, "calib_rot", rx)
            if s.btn_b and not self._b_prev:
                self.calibration_mode = False
                out.append(Action("calibration_save", 1.0))
            self._a_prev, self._b_prev = s.btn_a, s.btn_b
            self._ltrig_prev = s.trigger_l >= CROP_PRESS_THRESH
            return out
        if self._brand_combo.update(s.btn_a and s.btn_b and not s.btn_menu,
                                    now):
            out.append(Action("cycle_controller_brand"))

        # A double-press → hide/show all overlays (readme.md:233); single
        # presses stay with the click layer (input_map.ClickDragTracker)
        if self._a_prev and not s.btn_a and not s.btn_b:
            if self._a_tap.on_release(now):
                out.append(Action("toggle_all_overlays"))
        self._a_prev, self._b_prev = s.btn_a, s.btn_b

        # Both grips held 3 s (screen locked) → seat-adjust mode
        if self._seat_combo.update(s.grip_l and s.grip_r, now):
            self.seat_adjust_active = not self.seat_adjust_active
            out.append(Action("seat_adjust", float(self.seat_adjust_active)))

        # Crop gestures: left trigger while ITS laser is off the screen
        ltrig = s.trigger_l >= CROP_PRESS_THRESH
        if not s.laser_l_on_screen:
            if self._crop_hold.update(ltrig, now):
                self._crop_fired_press = True
                order = ("auto", "manual", "off")
                idx = order.index(self.crop_mode) if self.crop_mode in order else 0
                self.crop_mode = order[(idx + 1) % len(order)]
                if self.crop_mode != "manual":
                    self.crop_adjust_active = False
                out.append(Action("crop_mode", hand=self.crop_mode))
            elif self._ltrig_prev and not ltrig:
                # release without the hold having fired → tap (the
                # reference's _ltrig_hold_fired guard)
                if (not getattr(self, "_crop_fired_press", False)
                        and self.crop_mode == "manual"
                        and self._crop_tap.on_release(now)):
                    self.crop_adjust_active = not self.crop_adjust_active
                    out.append(Action("crop_adjust_pause",
                                      float(self.crop_adjust_active)))
                self._crop_fired_press = False
        else:  # laser back on screen cancels the gesture (reference resets)
            self._crop_hold.update(False, now)
            self._crop_fired_press = False
        self._ltrig_prev = ltrig

        # Crop-adjust: left stick (no grip), dominant axis only
        if self.crop_adjust_active and not s.grip_l and not s.grip_r:
            if _live(lx) or _live(ly):
                if abs(lx) >= abs(ly):
                    out.append(Action("crop_width", lx))
                else:
                    out.append(Action("crop_height", ly))
            # crop-adjust consumes the left stick entirely
            lx = ly = 0.0

        # Stick buttons: both pressed 0.5 s → FPS/help panel; singles get
        # short/long roles (input_handler.py:966-970)
        if self._both_sticks.update(s.stick_btn_l and s.stick_btn_r, now):
            out.append(Action("toggle_help_panel"))
        if s.stick_btn_l and s.stick_btn_r:
            # the chord owns both buttons: flush the single-press timers so
            # the combo's release can't replay as spurious short presses
            self._stick_btn_l.update(False, now)
            self._stick_btn_r.update(False, now)
        else:
            ev = self._stick_btn_l.update(s.stick_btn_l, now)
            if s.grip_r:
                # Right grip + left stick button: depth intensity zero/restore
                # toggle (readme.md:226)
                if ev == "short":
                    out.append(Action("toggle_depth_zero"))
            elif ev == "short":
                out.append(Action("cycle_background"))
            elif ev == "long":
                out.append(Action("toggle_help_panel"))
            ev = self._stick_btn_r.update(s.stick_btn_r, now)
            if not s.grip_r:
                if ev == "short":
                    out.append(Action("toggle_screen_curve"))
                elif ev == "long":
                    out.append(Action("reset_screen_orientation"))
            else:
                # Right grip + right stick button: reset depth scale to 2.0
                if ev == "short":
                    out.append(Action("reset_depth_scale"))

        # Left-hand buttons
        ev = self._y_btn.update(s.btn_y, now)
        if ev == "short":
            out.append(Action("reset_screen_pose"))
        elif ev == "long":
            out.append(Action("cycle_screen_preset"))
        ev = self._menu_btn.update(s.btn_menu and not (s.btn_a and s.btn_b),
                                   now)
        if ev == "short":
            out.append(Action("toggle_fps_overlay"))
        elif ev == "long":
            out.append(Action("reset_depth_ratio"))
        ev = self._x_btn.update(s.btn_x, now)
        if ev == "tap":
            out.append(Action("toggle_keyboard"))
        elif ev == "mid":
            out.append(Action("toggle_glow_mode"))
        elif ev == "top":
            out.append(Action("toggle_passthrough"))

        # Grip-gated stick routing (readme.md:197-232).  Left-grip chords
        # also suppress depth-zero on the left stick button (taken above
        # only when right grip holds).
        if s.grip_r and not s.grip_l:
            self._emit_axis(out, "screen_width", rx)
            self._emit_axis(out, "screen_distance", ry)
            self._emit_axis(out, "depth_scale", ly)
            self._emit_axis(out, "effect_transparency", lx)
            if s.btn_a and not s.btn_b:
                out.append(Action("depth_ratio_fine", +1.0))
            elif s.btn_b and not s.btn_a:
                out.append(Action("depth_ratio_fine", -1.0))
        elif s.grip_l and not s.grip_r:
            self._emit_axis(out, "screen_translate_x", lx)
            self._emit_axis(out, "screen_translate_y", ly)
            self._emit_axis(out, "screen_yaw", rx)
            self._emit_axis(out, "screen_pitch", ry)
        elif not s.grip_l and not s.grip_r:
            # free sticks belong to the mouse/arrow layer; report ownership
            # so callers feed input_map's ScrollAccumulator/ArrowRepeater
            self._emit_axis(out, "mouse_scroll_y", ry, "right")
            self._emit_axis(out, "mouse_scroll_x", rx, "right")
            self._emit_axis(out, "arrow_x", lx, "left")
            self._emit_axis(out, "arrow_y", ly, "left")

        # Grip-to-move: latch each grip onto ONE target at close (keyboard
        # beats screen; nothing hit stays unlatched and may catch next
        # tick), then drag that target while the grip is held, its stick
        # is idle, and both grips aren't chording
        # (input_handler.py:1146-1175; the pose math itself lives in
        # xr/geometry.py drag helpers)
        for grip, (sx, sy), laser, kb_hover, hand in (
                (s.grip_l, s.stick_l, s.laser_l_on_screen,
                 s.keyboard_hover_l, "left"),
                (s.grip_r, s.stick_r, s.laser_r_on_screen,
                 s.keyboard_hover_r, "right")):
            if not grip:
                self._grip_target[hand] = None
                continue
            if self._grip_target[hand] is None:
                if kb_hover:
                    self._grip_target[hand] = "keyboard"
                elif laser:
                    self._grip_target[hand] = "screen"
            target = self._grip_target[hand]
            if (target is not None and not (s.grip_l and s.grip_r)
                    and not (_live(sx) or _live(sy))
                    and (laser or target == "keyboard")):
                out.append(Action("drag_screen" if target == "screen"
                                  else "drag_keyboard", hand=hand))
        return out
