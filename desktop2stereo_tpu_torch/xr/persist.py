"""XR state persistence: screen pose per profile, runtime keys to settings.

Port of `desktop2stereo_tpu/xr/persist.py`: it writes through the port's
`core/config.py:update_yaml` (no PyYAML).

Mirrors the reference's two persistence channels (reference
xr_viewer/environment.py:1093-1240):

- the Default environment's screen layout saves into a merge-don't-clobber
  profile json under the `screen_state` key (`.builtin_default.json`);
  locked environments never persist (their layout comes from the profile);
- GUI-facing runtime values (environment model, controller model, depth
  strength, crop mode) write back into settings.yaml a key at a time so
  the control panel/GUI sees live XR-side changes.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

from desktop2stereo_tpu_torch.core.config import update_yaml
from desktop2stereo_tpu_torch.xr.geometry import ScreenPose

BUILTIN_PROFILE = ".builtin_default.json"


def screen_state_dict(pose: ScreenPose, curve_axis: str = "none",
                      preset_index: int = 0) -> Dict[str, Any]:
    """The persisted layout schema (reference environment.py:1178-1187)."""
    return {
        "width": round(float(pose.width), 4),
        "distance": round(float(pose.distance), 4),
        "pan_x": round(float(pose.pan_x), 4),
        "pan_y": round(float(pose.pan_y), 4),
        "yaw": round(float(pose.yaw), 6),
        "pitch": round(float(pose.pitch), 6),
        "curve_axis": curve_axis,
        "preset_index": int(preset_index),
    }


def persist_screen_state(profile_path: str, pose: ScreenPose,
                         curve_axis: str = "none", preset_index: int = 0,
                         locked: bool = False) -> bool:
    """Merge the screen layout into the profile json.  No-op (False) for
    locked environments (reference environment.py:1172-1177)."""
    if locked:
        return False
    profile: Dict[str, Any] = {}
    if os.path.isfile(profile_path):
        try:
            with open(profile_path, "r", encoding="utf-8-sig") as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                profile = loaded
        except (OSError, json.JSONDecodeError):
            pass
    profile["screen_state"] = screen_state_dict(pose, curve_axis, preset_index)
    try:
        with open(profile_path, "w", encoding="utf-8") as f:
            json.dump(profile, f, indent=2, ensure_ascii=False)
        return True
    except OSError:
        return False


def restore_screen_state(
    profile_path: str, base: Optional[ScreenPose] = None,
) -> Optional[Tuple[ScreenPose, str, int]]:
    """(pose, curve_axis, preset_index) from a persisted profile, or None
    (reference environment.py:1202-1240)."""
    try:
        with open(profile_path, "r", encoding="utf-8-sig") as f:
            profile = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    state = profile.get("screen_state") if isinstance(profile, dict) else None
    if not isinstance(state, dict):
        return None
    base = base or ScreenPose()

    def num(key: str, default: float) -> float:
        try:
            return float(state.get(key, default))
        except (TypeError, ValueError):
            return default

    pose = replace(
        base,
        width=num("width", base.width),
        distance=num("distance", base.distance),
        pan_x=num("pan_x", base.pan_x),
        pan_y=num("pan_y", base.pan_y),
        yaw=num("yaw", base.yaw),
        pitch=num("pitch", base.pitch),
    )
    curve = state.get("curve_axis")
    if curve not in ("horizontal", "vertical", "none"):
        curve = "none"
    try:
        preset = int(state.get("preset_index", 0))
    except (TypeError, ValueError):
        preset = 0
    return pose, curve, preset


def runtime_settings_snapshot(environment: str = "Default",
                              controller: Optional[str] = None,
                              depth_strength: float = 2.0,
                              crop_mode: str = "auto") -> Dict[str, Any]:
    """GUI-facing keys the XR side keeps live in settings.yaml (reference
    environment.py:1121-1129 _settings_snapshot)."""
    snap: Dict[str, Any] = {
        "Environment Model": environment or "Default",
        "Depth Strength": round(float(depth_strength), 4),
        "Crop Mode": crop_mode,
    }
    if controller:
        snap["Controller Model"] = controller
    return snap


def persist_runtime_settings(settings_path: str, **kw: Any) -> None:
    """Write the snapshot into settings.yaml, merge-don't-clobber."""
    update_yaml(settings_path, runtime_settings_snapshot(**kw))
