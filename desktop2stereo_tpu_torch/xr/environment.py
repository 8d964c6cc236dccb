"""XR environments: profile.json schema, discovery, default room, panorama.

Port of `desktop2stereo_tpu/xr/environment.py`, copied: host numpy.

Host-side analog of the reference's environment subsystem (reference
xr_viewer/environment.py:55-1800, schema xr_viewer/environments/README.md):
each environment folder holds an `environment.glb` (parsed by xr.glb) and
an optional `profile.json` with alias-tolerant keys for the model
transform, lighting, fill lights, lighting presets, a locked screen
layout, viewer seating, and panorama configuration.  The geometry
generators (default room, panorama sphere) replace the reference's
GL-resident meshes with plain numpy vertex arrays any renderer can upload.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PANORAMA_TYPES = frozenset({
    "panorama", "360", "360_photo", "360-photo", "equirectangular",
    "photo_sphere", "photosphere",
})
PANORAMA_IMAGE_EXTS = (".jpg", ".jpeg", ".png")

# Defaults mirror the documented schema (environments/README.md:38-60).
DEFAULT_AMBIENT = (0.08, 0.08, 0.09)
DEFAULT_HEAD_LIGHT = (0.45, 0.45, 0.48)
DARK_ROOM_AMBIENT = (0.012, 0.012, 0.015)


def _get(profile: dict, keys: Sequence[str], default=None):
    """First present key wins — the alias-tolerance rule (reference
    environment.py:1044-1067)."""
    for k in keys:
        if k in profile:
            return profile[k]
    return default


def _vec3(profile: dict, keys: Sequence[str],
          default: Tuple[float, float, float]) -> Tuple[float, float, float]:
    v = _get(profile, keys)
    if not isinstance(v, (list, tuple)) or len(v) != 3:
        return default
    try:
        return (float(v[0]), float(v[1]), float(v[2]))
    except (TypeError, ValueError):
        return default


def _float(profile: dict, keys: Sequence[str], default: float) -> float:
    v = _get(profile, keys)
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def curve_mode_from_json(data: dict) -> str:
    """'horizontal' | 'vertical' | 'none', honouring the legacy boolean
    `curved` (reference environment.py:985-1002)."""
    mode = data.get("curve_axis")
    if isinstance(mode, str):
        m = mode.strip().lower()
        if m in ("horizontal", "vertical", "none"):
            return m
    legacy = data.get("curved")
    if legacy is True:
        return "horizontal"
    return "none"


@dataclass(frozen=True)
class FillLight:
    position: Tuple[float, float, float] = (0.0, 2.0, -1.0)
    color: Tuple[float, float, float] = (0.8, 0.7, 0.5)
    range: float = 5.0


@dataclass(frozen=True)
class ViewPose:
    name: str = ""
    x: float = 0.0
    y: float = 1.6
    z: float = -2.0
    angle_deg: float = 0.0


@dataclass(frozen=True)
class ScreenLayout:
    """Locked screen placement — present ⇒ the user can't grab-move the
    screen (reference environments/README.md 'Screen Layout')."""

    width: float = 4.0
    position: Tuple[float, float, float] = (0.0, 1.5, -6.0)
    rotation_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    curve_axis: str = "none"
    allow_curve: bool = True


@dataclass(frozen=True)
class Lighting:
    exposure: float = 1.0
    gamma: float = 2.2
    emissive_strength: float = 1.0
    khr_light_scale: float = 1.0
    ambient_color: Tuple[float, float, float] = DEFAULT_AMBIENT
    head_light_color: Tuple[float, float, float] = DEFAULT_HEAD_LIGHT
    screen_light_intensity: float = 3.5


@dataclass(frozen=True)
class LightingPreset:
    name: str
    lighting: Lighting


@dataclass(frozen=True)
class EnvironmentProfile:
    display_name: Dict[str, str] = field(default_factory=dict)
    glb: str = "environment.glb"
    model_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    model_rotation_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    model_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    lighting: Lighting = Lighting()
    fill_lights: Tuple[FillLight, ...] = ()
    lighting_presets: Tuple[LightingPreset, ...] = ()
    screen: Optional[ScreenLayout] = None
    view_poses: Tuple[ViewPose, ...] = ()
    view_pose_index: int = 0
    panorama: Optional[str] = None   # image path (equirect) if panorama env

    @property
    def locked(self) -> bool:
        return self.screen is not None

    def name_for(self, lang: str = "EN") -> Optional[str]:
        return self.display_name.get(lang) or next(
            iter(self.display_name.values()), None)


def _parse_lighting(p: dict, base: Lighting = Lighting()) -> Lighting:
    return Lighting(
        exposure=_float(p, ("env_exposure",), base.exposure),
        gamma=_float(p, ("env_gamma",), base.gamma),
        emissive_strength=_float(p, ("env_emissive_strength",),
                                 base.emissive_strength),
        khr_light_scale=_float(p, ("env_khr_light_scale", "khr_light_scale"),
                               base.khr_light_scale),
        ambient_color=_vec3(p, ("env_ambient_color", "ambient_color"),
                            base.ambient_color),
        head_light_color=_vec3(p, ("env_head_light_color", "head_light_color"),
                               base.head_light_color),
        screen_light_intensity=_float(p, ("screen_light_intensity",),
                                      base.screen_light_intensity),
    )


def parse_profile(p: dict, room_dir: Optional[str] = None) -> EnvironmentProfile:
    """Alias-tolerant profile.json → EnvironmentProfile (reference
    environment.py:534-716).  Unknown keys are ignored, all fields optional."""
    dn = p.get("display_name")
    display_name = ({str(k): str(v) for k, v in dn.items()}
                    if isinstance(dn, dict) else {})

    fill = []
    for fl in _get(p, ("env_fill_lights", "fallback_lights"), []) or []:
        if isinstance(fl, dict):
            fill.append(FillLight(
                position=_vec3(fl, ("position",), (0.0, 2.0, -1.0)),
                color=_vec3(fl, ("color",), (0.8, 0.7, 0.5)),
                range=_float(fl, ("range",), 5.0),
            ))

    base_lighting = _parse_lighting(p)
    presets = []
    for pr in p.get("lighting_presets", []) or []:
        if isinstance(pr, dict):
            presets.append(LightingPreset(
                name=str(pr.get("name", f"Preset {len(presets) + 1}")),
                lighting=_parse_lighting(pr, base_lighting),
            ))

    screen = None
    sc = p.get("screen")
    if isinstance(sc, dict):
        screen = ScreenLayout(
            width=_float(sc, ("width", "screen_width"), 4.0),
            position=_vec3(sc, ("position", "screen_position"),
                           (0.0, 1.5, -6.0)),
            rotation_deg=_vec3(sc, ("rotation_deg", "screen_rotation_deg"),
                               (0.0, 0.0, 0.0)),
            curve_axis=curve_mode_from_json(sc),
            allow_curve=bool(sc.get("allow_curve", True)),
        )

    poses: List[ViewPose] = []
    for vp in p.get("view_poses", []) or []:
        if isinstance(vp, dict):
            poses.append(ViewPose(
                name=str(vp.get("name", f"Seat {len(poses) + 1}")),
                x=_float(vp, ("x",), 0.0), y=_float(vp, ("y",), 1.6),
                z=_float(vp, ("z",), -2.0),
                angle_deg=_float(vp, ("angle",), 0.0),
            ))
    if not poses:
        vp = _get(p, ("view_pose", "camera"))
        if isinstance(vp, dict):
            poses.append(ViewPose(
                name=str(vp.get("name", "Seat")),
                x=_float(vp, ("x",), 0.0), y=_float(vp, ("y",), 1.6),
                z=_float(vp, ("z",), -2.0),
                angle_deg=_float(vp, ("angle",), 0.0),
            ))

    panorama = None
    env_type = str(p.get("type", "")).strip().lower()
    bg_type = str(p.get("background", "")).strip().lower()
    explicit = _get(p, ("panorama", "panorama_image", "image"))
    if isinstance(explicit, str) and explicit:
        panorama = (os.path.join(room_dir, explicit)
                    if room_dir and not os.path.isabs(explicit) else explicit)
    elif env_type in PANORAMA_TYPES or bg_type in PANORAMA_TYPES:
        if room_dir:
            panorama = find_panorama_image(room_dir)

    idx = p.get("view_pose_index", 0)
    return EnvironmentProfile(
        display_name=display_name,
        glb=str(p.get("glb", "environment.glb")),
        model_position=_vec3(p, ("model_position", "position"), (0.0,) * 3),
        model_rotation_deg=_vec3(p, ("model_rotation_deg", "rotation_deg"),
                                 (0.0,) * 3),
        model_scale=_vec3(p, ("model_scale", "scale"), (1.0,) * 3),
        lighting=base_lighting,
        fill_lights=tuple(fill),
        lighting_presets=tuple(presets),
        screen=screen,
        view_poses=tuple(poses),
        view_pose_index=int(idx) if isinstance(idx, (int, float)) else 0,
        panorama=panorama,
    )


def load_profile(room_dir: str) -> EnvironmentProfile:
    """Read `<room_dir>/profile.json` (absent/empty → all defaults), with a
    GBK fallback matching the settings loader's tolerance."""
    path = os.path.join(room_dir, "profile.json")
    if not os.path.isfile(path):
        return parse_profile({}, room_dir)
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except UnicodeDecodeError:
        # The GBK retry can itself fail (bytes invalid in both codecs, or
        # GBK-decoding to broken JSON); one bad profile must not kill the
        # whole environment scan.
        try:
            with open(path, "r", encoding="gbk") as f:
                data = json.load(f)
        except (OSError, ValueError, UnicodeDecodeError):
            return parse_profile({}, room_dir)
    except (OSError, json.JSONDecodeError):
        return parse_profile({}, room_dir)
    if not isinstance(data, dict):
        data = {}
    return parse_profile(data, room_dir)


def find_panorama_image(room_dir: str) -> Optional[str]:
    """Auto-discover an equirect image in the folder (reference
    environment.py:299-316)."""
    try:
        entries = sorted(os.listdir(room_dir))
    except OSError:
        return None
    for name in entries:
        if name.lower().endswith(PANORAMA_IMAGE_EXTS):
            return os.path.join(room_dir, name)
    return None


def discover_environments(root: str) -> Dict[str, EnvironmentProfile]:
    """Folder scan: any subdir with an environment.glb OR a panorama config
    is an environment (reference environment.py:415-451)."""
    out: Dict[str, EnvironmentProfile] = {}
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        prof = load_profile(d)
        has_glb = os.path.isfile(os.path.join(d, prof.glb))
        if has_glb or prof.panorama:
            out[name] = prof
    return out


# ----------------------------------------------------------- geometry ------

def default_room(width: float = 8.0, height: float = 3.2,
                 depth: float = 10.0) -> np.ndarray:
    """Generated fallback room (reference environment.py:221-287): an
    inward-facing box (floor, ceiling, 4 walls) centred on the viewer,
    floor at y=0.  Returns triangles [N, 8]: (x y z  nx ny nz  u v)."""
    hw, hd = width / 2.0, depth / 2.0
    quads = [
        # floor (+Y normal), ceiling (−Y), back/front/left/right walls
        (((-hw, 0, -hd), (hw, 0, -hd), (hw, 0, hd), (-hw, 0, hd)), (0, 1, 0)),
        (((-hw, height, hd), (hw, height, hd), (hw, height, -hd),
          (-hw, height, -hd)), (0, -1, 0)),
        (((-hw, 0, -hd), (-hw, height, -hd), (hw, height, -hd),
          (hw, 0, -hd)), (0, 0, 1)),
        (((hw, 0, hd), (hw, height, hd), (-hw, height, hd),
          (-hw, 0, hd)), (0, 0, -1)),
        (((-hw, 0, hd), (-hw, height, hd), (-hw, height, -hd),
          (-hw, 0, -hd)), (1, 0, 0)),
        (((hw, 0, -hd), (hw, height, -hd), (hw, height, hd),
          (hw, 0, hd)), (-1, 0, 0)),
    ]
    uv = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
    tris: List[List[float]] = []
    for corners, n in quads:
        order = (0, 1, 2, 0, 2, 3)
        for i in order:
            tris.append([*corners[i], *n, *uv[i]])
    return np.asarray(tris, np.float32)


def panorama_sphere(segments: int = 48, rings: int = 24,
                    radius: float = 50.0) -> np.ndarray:
    """Inward-facing UV sphere for equirect panoramas (reference
    environment.py panorama path).  Triangles [N, 5]: (x y z u v); u wraps
    longitude (0 at -Z, increasing eastward), v=0 at the bottom pole."""
    tris: List[List[float]] = []

    def vert(r: int, s: int) -> List[float]:
        v = r / rings
        u = s / segments
        theta = v * math.pi            # 0 = bottom pole
        phi = u * 2.0 * math.pi
        y = -math.cos(theta) * radius
        rr = math.sin(theta) * radius
        x = math.sin(phi) * rr
        z = -math.cos(phi) * rr
        return [x, y, z, u, v]

    for r in range(rings):
        for s in range(segments):
            a, b = vert(r, s), vert(r, s + 1)
            c, d = vert(r + 1, s + 1), vert(r + 1, s)
            # inward winding
            tris.extend([a, c, b, a, d, c])
    return np.asarray(tris, np.float32)


def dark_room_profile() -> EnvironmentProfile:
    """The no-environment fallback: generated room, near-black lighting
    (reference environment.py:349-366)."""
    return EnvironmentProfile(
        display_name={"EN": "Dark Room", "CN": "暗室"},
        lighting=Lighting(
            exposure=0.6,
            ambient_color=DARK_ROOM_AMBIENT,
            head_light_color=(0.06, 0.06, 0.08),
        ),
    )
