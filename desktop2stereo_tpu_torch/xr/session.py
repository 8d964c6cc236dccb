"""XR session management as a runtime-agnostic state machine.

Port of `desktop2stereo_tpu/xr/session.py`, copied: plain Python.

Host-side analog of the reference's OpenXR session mixin (reference
xr_viewer/xr_session.py:17-671): headset hot-wait retry loop, reference
space preference (STAGE with floor origin, else LOCAL), per-eye swapchain
negotiation at the recommended resolution with an sRGB-first format
preference, per-vendor controller binding suggestion tables, and the
OpenXR session lifecycle (IDLE → READY → SYNCHRONIZED → VISIBLE → FOCUSED
→ STOPPING).  The actual runtime (pyopenxr, a remote frame client, a test
fake) plugs in behind the small `RuntimeAdapter` protocol; everything
here is pure logic, so the policy is testable without a headset — and a
workstation client of the XR frame server can reuse it verbatim.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

# GL_SRGB8_ALPHA8 first: desktop captures are sRGB-encoded; signalling it
# keeps the compositor from double-correcting (reference constants.py:31+).
GL_SRGB8_ALPHA8 = 0x8C43
GL_RGBA8 = 0x8058
PREFERRED_COLOR_FORMATS: Tuple[int, ...] = (GL_SRGB8_ALPHA8, GL_RGBA8)


class ReferenceSpace(Enum):
    STAGE = "stage"    # floor origin — preferred (reference xr_session.py:171-176)
    LOCAL = "local"


class SessionPhase(Enum):
    IDLE = "idle"
    READY = "ready"
    SYNCHRONIZED = "synchronized"
    VISIBLE = "visible"
    FOCUSED = "focused"
    STOPPING = "stopping"
    EXITING = "exiting"


@dataclass(frozen=True)
class SwapchainSpec:
    width: int
    height: int
    format: int
    sample_count: int = 1


@dataclass(frozen=True)
class SystemInfo:
    """What the runtime reports once a headset is present."""

    recommended_size: Tuple[int, int]       # per-eye (w, h)
    color_formats: Tuple[int, ...]          # supported, runtime-ordered
    reference_spaces: Tuple[ReferenceSpace, ...]
    vendor_profiles: Tuple[str, ...] = ()   # supported interaction profiles


class RuntimeAdapter(Protocol):
    """The five runtime touch-points the policy needs."""

    def probe_system(self) -> Optional[SystemInfo]:
        """None while no headset is connected."""
        ...

    def create_session(self, space: ReferenceSpace,
                       swapchains: Sequence[SwapchainSpec]) -> None: ...

    def destroy_session(self) -> None: ...

    def suggest_bindings(self, profile: str,
                         bindings: Sequence[Tuple[str, str]]) -> bool:
        """Returns False if the runtime rejects the profile."""
        ...


# Per-vendor binding tables: interaction profile → (action, component path)
# (structure after reference xr_session.py:340-433; paths are the OpenXR
# standard component paths).
BINDING_TABLES: Dict[str, List[Tuple[str, str]]] = {
    "/interaction_profiles/oculus/touch_controller": [
        ("aim_pose", "/user/hand/left/input/aim/pose"),
        ("aim_pose", "/user/hand/right/input/aim/pose"),
        ("grip_pose", "/user/hand/left/input/grip/pose"),
        ("grip_pose", "/user/hand/right/input/grip/pose"),
        ("trigger", "/user/hand/left/input/trigger/value"),
        ("trigger", "/user/hand/right/input/trigger/value"),
        ("squeeze", "/user/hand/left/input/squeeze/value"),
        ("squeeze", "/user/hand/right/input/squeeze/value"),
        ("stick", "/user/hand/left/input/thumbstick"),
        ("stick", "/user/hand/right/input/thumbstick"),
        ("stick_click", "/user/hand/left/input/thumbstick/click"),
        ("stick_click", "/user/hand/right/input/thumbstick/click"),
        ("button_primary", "/user/hand/right/input/a/click"),
        ("button_secondary", "/user/hand/right/input/b/click"),
        ("button_x", "/user/hand/left/input/x/click"),
        ("button_y", "/user/hand/left/input/y/click"),
        ("menu", "/user/hand/left/input/menu/click"),
    ],
    "/interaction_profiles/valve/index_controller": [
        ("aim_pose", "/user/hand/left/input/aim/pose"),
        ("aim_pose", "/user/hand/right/input/aim/pose"),
        ("grip_pose", "/user/hand/left/input/grip/pose"),
        ("grip_pose", "/user/hand/right/input/grip/pose"),
        ("trigger", "/user/hand/left/input/trigger/value"),
        ("trigger", "/user/hand/right/input/trigger/value"),
        ("squeeze", "/user/hand/left/input/squeeze/value"),
        ("squeeze", "/user/hand/right/input/squeeze/value"),
        ("stick", "/user/hand/left/input/thumbstick"),
        ("stick", "/user/hand/right/input/thumbstick"),
        ("button_primary", "/user/hand/right/input/a/click"),
        ("button_secondary", "/user/hand/right/input/b/click"),
    ],
    "/interaction_profiles/htc/vive_controller": [
        ("aim_pose", "/user/hand/left/input/aim/pose"),
        ("aim_pose", "/user/hand/right/input/aim/pose"),
        ("grip_pose", "/user/hand/left/input/grip/pose"),
        ("grip_pose", "/user/hand/right/input/grip/pose"),
        ("trigger", "/user/hand/left/input/trigger/value"),
        ("trigger", "/user/hand/right/input/trigger/value"),
        ("squeeze", "/user/hand/left/input/squeeze/click"),
        ("squeeze", "/user/hand/right/input/squeeze/click"),
        # trackpad stands in for the stick; button emulation happens in
        # input mapping (reference xr_session.py:640-660 trackpad zones)
        ("stick", "/user/hand/left/input/trackpad"),
        ("stick", "/user/hand/right/input/trackpad"),
        ("menu", "/user/hand/left/input/menu/click"),
    ],
    "/interaction_profiles/khr/simple_controller": [
        ("aim_pose", "/user/hand/left/input/aim/pose"),
        ("aim_pose", "/user/hand/right/input/aim/pose"),
        ("trigger", "/user/hand/left/input/select/click"),
        ("trigger", "/user/hand/right/input/select/click"),
        ("menu", "/user/hand/left/input/menu/click"),
    ],
}

# VIVE trackpad → virtual button zones (reference constants.py _VIVE_TB_Y,
# xr_session.py:640-660): the trackpad's top/bottom thirds emulate the
# missing A/B/X/Y buttons.
VIVE_TRACKPAD_ZONE_Y = 0.6


def trackpad_button_zone(x: float, y: float) -> Optional[str]:
    """'top' | 'bottom' for VIVE trackpad button emulation, None in the
    stick zone."""
    if y > VIVE_TRACKPAD_ZONE_Y:
        return "top"
    if y < -VIVE_TRACKPAD_ZONE_Y:
        return "bottom"
    return None


def choose_reference_space(available: Sequence[ReferenceSpace]) -> ReferenceSpace:
    """STAGE (floor origin) if offered, else LOCAL (reference
    xr_session.py:171-176)."""
    return (ReferenceSpace.STAGE if ReferenceSpace.STAGE in available
            else ReferenceSpace.LOCAL)


def choose_color_format(supported: Sequence[int]) -> int:
    """First of OUR preference list the runtime supports; else the
    runtime's own first choice (reference xr_session.py:200-210)."""
    for fmt in PREFERRED_COLOR_FORMATS:
        if fmt in supported:
            return fmt
    return supported[0]


def plan_swapchains(info: SystemInfo) -> List[SwapchainSpec]:
    """One sRGB swapchain per eye at the recommended resolution."""
    w, h = info.recommended_size
    fmt = choose_color_format(info.color_formats)
    return [SwapchainSpec(w, h, fmt), SwapchainSpec(w, h, fmt)]


@dataclass
class SessionManager:
    """Hot-wait + bring-up + lifecycle policy around a RuntimeAdapter."""

    runtime: RuntimeAdapter
    retry_delay: float = 2.0     # reference xr_session.py:42
    poll_step: float = 0.05      # keeps shutdown responsive while waiting
    phase: SessionPhase = SessionPhase.IDLE
    info: Optional[SystemInfo] = None
    space: Optional[ReferenceSpace] = None
    swapchains: List[SwapchainSpec] = field(default_factory=list)
    bound_profiles: List[str] = field(default_factory=list)

    def wait_for_device(self, should_stop: Callable[[], bool],
                        sleep=time.sleep,
                        max_attempts: Optional[int] = None) -> Optional[SystemInfo]:
        """Poll until a headset appears, sleeping retry_delay between probes
        in small steps so a shutdown request interrupts promptly (reference
        xr_session.py:42-64).  Returns None if stopped first."""
        attempts = 0
        while not should_stop():
            info = self.runtime.probe_system()
            if info is not None:
                self.info = info
                return info
            attempts += 1
            if max_attempts is not None and attempts >= max_attempts:
                return None
            waited = 0.0
            while waited < self.retry_delay:
                if should_stop():
                    return None
                sleep(self.poll_step)
                waited += self.poll_step
        return None

    def bring_up(self) -> None:
        """Create the session: reference space choice, swapchain plan,
        binding suggestions for every vendor table the runtime accepts."""
        assert self.info is not None, "wait_for_device first"
        self.space = choose_reference_space(self.info.reference_spaces)
        self.swapchains = plan_swapchains(self.info)
        self.runtime.create_session(self.space, self.swapchains)
        self.bound_profiles = [
            profile for profile, table in BINDING_TABLES.items()
            if self.runtime.suggest_bindings(profile, table)
        ]
        self.phase = SessionPhase.READY

    # Legal OpenXR state transitions this app cares about.
    _TRANSITIONS = {
        SessionPhase.IDLE: {SessionPhase.READY},
        SessionPhase.READY: {SessionPhase.SYNCHRONIZED, SessionPhase.STOPPING},
        SessionPhase.SYNCHRONIZED: {SessionPhase.VISIBLE, SessionPhase.STOPPING},
        SessionPhase.VISIBLE: {SessionPhase.FOCUSED, SessionPhase.SYNCHRONIZED,
                               SessionPhase.STOPPING},
        SessionPhase.FOCUSED: {SessionPhase.VISIBLE, SessionPhase.STOPPING},
        SessionPhase.STOPPING: {SessionPhase.IDLE, SessionPhase.EXITING},
    }

    def on_state(self, new: SessionPhase) -> bool:
        """Apply a runtime state event; False (ignored) if not legal from
        the current phase."""
        if new in self._TRANSITIONS.get(self.phase, set()):
            self.phase = new
            return True
        return False

    @property
    def should_render(self) -> bool:
        return self.phase in (SessionPhase.VISIBLE, SessionPhase.FOCUSED)

    def tear_down(self) -> None:
        """Release for a clean retry (reference xr_session.py:67-115)."""
        try:
            self.runtime.destroy_session()
        finally:
            self.phase = SessionPhase.IDLE
            self.space = None
            self.swapchains = []
            self.bound_profiles = []


@dataclass
class FrameTimer:
    """Display-rate estimate from predicted display periods with a
    timestamp-ring fallback (reference implementation.py:208-213,
    2066-2087)."""

    ring_size: int = 90
    _times: List[float] = field(default_factory=list)

    def push_period_ns(self, period_ns: int) -> Optional[float]:
        if period_ns > 0:
            return 1e9 / period_ns
        return None

    def push_timestamp(self, t: float) -> Optional[float]:
        self._times.append(t)
        if len(self._times) > self.ring_size:
            self._times.pop(0)
        if len(self._times) < 2:
            return None
        span = self._times[-1] - self._times[0]
        if span <= 0:
            return None
        return (len(self._times) - 1) / span
