"""Monitor geometry, refresh-rate detection and output-resolution policy.

Port of `desktop2stereo_tpu/core/display.py` (stdlib only, so the same
code): the reference's per-OS display probing (reference utils.py:287-571
`get_fps`, 304-314 `get_monitor_size`, 316-343
`compute_output_resolution`).  A GPU server usually runs headless, so every
probe degrades gracefully: xrandr (when an X display is reachable), then the
DRM sysfs mode list, then fixed defaults — never an exception.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
from typing import Optional, Tuple

DEFAULT_SIZE = (3840, 2160)
DEFAULT_FPS = 60.0

# Output modes whose Auto resolution derives from the stereo monitor; all
# others (headless streaming, file sinks, XR) process the captured frame at
# native size via the no-resize sentinel (reference utils.py:334-338).
AUTO_COMPUTE_MODES = frozenset({"Local Viewer", "3D Monitor", "RTMP Streamer"})
NO_RESIZE_SENTINEL = 8640


def _xrandr_modes() -> list:
    """[(width, height, hz, is_current), ...] from `xrandr --current`."""
    out = subprocess.run(
        ["xrandr", "--current"], capture_output=True, text=True, timeout=3,
    ).stdout
    modes = []
    for line in out.splitlines():
        m = re.match(r"\s+(\d+)x(\d+)\s+(.*)", line)
        if not m:
            continue
        w, h = int(m.group(1)), int(m.group(2))
        for rate in re.finditer(r"(\d+(?:\.\d+)?)(\*?)\+?", m.group(3)):
            modes.append((w, h, float(rate.group(1)), rate.group(2) == "*"))
    return modes


def list_monitors() -> list:
    """[(name, x, y, w, h)] from `xrandr --listmonitors` — the per-monitor
    rects inside the X11 root window (the reference's monitor enumeration +
    clamp, reference capture.py:_choose_monitor_and_rect, utils.py mss
    monitors).  Empty on headless hosts."""
    try:
        out = subprocess.run(
            ["xrandr", "--listmonitors"], capture_output=True, text=True,
            timeout=3,
        ).stdout
    except Exception:
        return []
    mons = []
    for line in out.splitlines():
        # " 0: +*eDP-1 1920/309x1080/173+0+0  eDP-1"
        m = re.match(
            r"\s*\d+:\s+\S+\s+(\d+)/\d+x(\d+)/\d+\+(\d+)\+(\d+)\s+(\S+)", line)
        if m:
            w, h, x, y, name = (int(m.group(1)), int(m.group(2)),
                                int(m.group(3)), int(m.group(4)), m.group(5))
            mons.append((name, x, y, w, h))
    return mons


def monitor_rect(monitor_index: int) -> Optional[Tuple[int, int, int, int]]:
    """(x, y, w, h) of the indexed monitor in root coordinates, or None if
    enumeration fails / index is out of range (callers fall back to the
    whole root, matching the reference's best-monitor clamp)."""
    mons = list_monitors()
    if 0 <= monitor_index < len(mons):
        _name, x, y, w, h = mons[monitor_index]
        return x, y, w, h
    return None


def _drm_modes() -> list:
    """[(width, height)] from /sys/class/drm/*/modes (no rates exposed)."""
    sizes = []
    for path in glob.glob("/sys/class/drm/card*-*/modes"):
        try:
            with open(path) as f:
                for line in f:
                    m = re.match(r"(\d+)x(\d+)", line.strip())
                    if m:
                        sizes.append((int(m.group(1)), int(m.group(2))))
        except OSError:
            continue
    return sizes


def get_monitor_size(monitor_index: Optional[int] = None) -> Tuple[int, int]:
    """(width, height) of the target monitor; defaults on headless hosts
    (reference utils.py:304-314)."""
    del monitor_index  # single-output assumption off-desktop
    try:
        if os.environ.get("DISPLAY"):
            current = [(w, h) for w, h, _, cur in _xrandr_modes() if cur]
            if current:
                return current[0]
    except Exception:
        pass
    try:
        drm = _drm_modes()
        if drm:
            return max(drm)  # preferred mode listed first ≈ largest
    except Exception:
        pass
    return DEFAULT_SIZE


def get_refresh_rate(monitor_index: Optional[int] = None) -> float:
    """Monitor refresh rate in Hz, 60 when undetectable (reference
    utils.py:287-301 `get_fps`)."""
    del monitor_index
    try:
        if os.environ.get("DISPLAY"):
            current = [hz for _, _, hz, cur in _xrandr_modes() if cur and hz > 0]
            if current:
                return float(current[0])
    except Exception:
        pass
    return DEFAULT_FPS


def compute_output_resolution(
    setting_value,
    display_mode: str = "Half-SBS",
    run_mode: Optional[str] = None,
    monitor_index: Optional[int] = None,
) -> int:
    """Resolve the processing height before depth inference (reference
    utils.py:316-343): an explicit positive int wins; "Auto" uses the stereo
    monitor's height (halved for Full-TAB, snapped even) for modes that own
    a viewer window, and the no-resize sentinel otherwise."""
    try:
        if isinstance(setting_value, str):
            v = setting_value.strip()
            if v and v.lower() != "auto":
                parsed = int(v)
                if parsed > 0:
                    return parsed
        elif setting_value:
            parsed = int(setting_value)
            if parsed > 0:
                return parsed
    except (TypeError, ValueError):
        pass

    if run_mode not in AUTO_COMPUTE_MODES:
        return NO_RESIZE_SENTINEL

    _, out_h = get_monitor_size(monitor_index)
    if display_mode == "Full-TAB":
        out_h = max(1, out_h // 2)
    return max(2, (int(out_h) // 2) * 2)
