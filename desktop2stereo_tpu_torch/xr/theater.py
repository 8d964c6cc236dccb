"""The XR virtual theater: one scene assembler for every presenter.

Port of `desktop2stereo_tpu/xr/theater.py`: the frame-derived effects run as
torch ops on the screen texture's device (see `frame_items`); the rest is a
copy, host numpy.

The reference's `_render_eye` composites, per eye per frame: the
environment GLB scene (or a generated room) with KHR punctual lights and
fill lights, an equirect panorama sphere, the virtual screen with the
DIBR warp, a screen-glow band, a frost veil, ambient light spill from the
screen content, laser beams + hit circles, controller models, and the
OSD/keyboard overlay quads (reference xr_viewer/implementation.py:1880-2045,
environment.py:55-1800, effects.py:26-1229 + glsl.py:580-791,
laser.py:25-833, overlay.py:30-1511).

Here all of that policy lives in ONE renderer-agnostic place: `Theater`
owns the scene state (environment profile, screen pose, ui toggles,
lasers, keyboard, stats) and emits an ordered `DrawItem` list per frame.
Two backends consume it: the numpy rasterizer (xr/raster.py — headless
tests, png/cv presenters) and the PyOpenGL backend (xr/gl_theater.py —
glfw window + OpenXR swapchains).  Every ui_state toggle routed by the
chord router (xr/controls.py) changes the emitted list, so toggles change
pixels in BOTH backends by construction.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.xr import glb as glb_mod
from desktop2stereo_tpu_torch.xr.controller_models import controller_mesh
from desktop2stereo_tpu_torch.xr.effects import (
    BACKGROUND_COLORS, ambient_spill, border_glow_color, frost_lod,
    glow_band_mesh)
from desktop2stereo_tpu_torch.xr.environment import (
    EnvironmentProfile, dark_room_profile, default_room, load_profile,
    panorama_sphere)
from desktop2stereo_tpu_torch.xr.geometry import ScreenPose
from desktop2stereo_tpu_torch.xr.keyboard import KeyboardState, build_layout
from desktop2stereo_tpu_torch.xr.laser import BEAM_MAX, PlaneSpec, RayHit
from desktop2stereo_tpu_torch.xr.overlay import (
    OverlayThrottle, fps_panel, render_help_panel, render_keyboard_texture)
from desktop2stereo_tpu_torch.xr.raster import DrawItem

PASSTHROUGH_KEY = (0.0, 1.0, 0.0)
BEAM_COLORS = {"left": (0.25, 0.75, 1.0), "right": (1.0, 0.62, 0.2)}
_SPILL_SUBSAMPLE = 8
# Seated eye height above the environment floor (the reference's STAGE
# space puts y=0 on the floor and the head ~1.4-1.7 m up; its seat-height
# control nudges this, reference xr_viewer/screen.py seat adjust).
EYE_HEIGHT = 1.4


@dataclass
class LaserBeam:
    """One hand's live aim ray for beam/controller rendering."""

    hand: str
    origin: np.ndarray
    direction: np.ndarray
    hit: Optional[RayHit] = None
    visible: bool = True


def _default_ui() -> Dict[str, object]:
    """Canonical ui_state (shared with OpenXRPresenter's chord routing)."""
    return {"fps_overlay": False, "help_panel": False, "keyboard": False,
            "glow": False, "passthrough": False, "overlays_hidden": False,
            "background": 0, "curved": False, "effect_transparency": 1.0}


# ------------------------------------------------------------- lighting ---


def lit_vertex_colors(pos: np.ndarray, nrm: Optional[np.ndarray],
                      base_rgb: Sequence[float], profile: EnvironmentProfile,
                      lights: Sequence[glb_mod.Light] = (),
                      head_pos: Sequence[float] = (0.0, 1.6, 0.0)) -> np.ndarray:
    """Per-vertex lit RGBA for environment geometry.

    Mirrors the reference's env shading terms (reference
    environment.py:55-1800): ambient + head light + KHR punctual lights ×
    khr_light_scale + fill lights with linear range falloff, through an
    exposure scale and display gamma."""
    L = profile.lighting
    n = pos.shape[0]
    light = np.tile(np.asarray(L.ambient_color, np.float32), (n, 1))
    head = np.asarray(head_pos, np.float32)

    if nrm is None:
        light = light + 0.5 * np.asarray(L.head_light_color, np.float32)
    else:
        to_head = head[None, :] - pos
        d = np.linalg.norm(to_head, axis=1, keepdims=True)
        to_head = to_head / np.maximum(d, 1e-6)
        ndl = np.maximum((nrm * to_head).sum(1, keepdims=True), 0.0)
        light = light + ndl * np.asarray(L.head_light_color, np.float32)

        for lt in lights:
            col = np.asarray(lt.color, np.float32) * (
                lt.intensity * L.khr_light_scale)
            if lt.kind == "directional":
                ndl = np.maximum(
                    -(nrm @ np.asarray(lt.direction, np.float32)), 0.0)
                light = light + ndl[:, None] * np.minimum(col, 4.0)
            else:  # point / spot → inverse-square point
                to_l = np.asarray(lt.position, np.float32)[None, :] - pos
                d2 = (to_l * to_l).sum(1, keepdims=True)
                dirn = to_l / np.maximum(np.sqrt(d2), 1e-6)
                ndl = np.maximum((nrm * dirn).sum(1, keepdims=True), 0.0)
                light = light + ndl * col[None, :] / np.maximum(d2, 0.25)

        for fl in profile.fill_lights:
            to_l = np.asarray(fl.position, np.float32)[None, :] - pos
            d = np.linalg.norm(to_l, axis=1, keepdims=True)
            w = np.maximum(1.0 - d / max(fl.range, 1e-6), 0.0)
            dirn = to_l / np.maximum(d, 1e-6)
            ndl = np.maximum((nrm * dirn).sum(1, keepdims=True), 0.0)
            light = light + w * ndl * np.asarray(fl.color, np.float32)

    rgb = np.asarray(base_rgb, np.float32)[None, :3] * light * L.exposure
    rgb = np.clip(rgb, 0.0, 8.0) ** (1.0 / max(L.gamma, 1e-3))
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.concatenate([rgb, np.ones((n, 1), np.float32)], axis=1)


def _quad(center: np.ndarray, right: np.ndarray, up: np.ndarray,
          w: float, h: float) -> Tuple[np.ndarray, np.ndarray]:
    """Two triangles + image-convention uvs (v=0 top row)."""
    r = right * (w / 2.0)
    u = up * (h / 2.0)
    p00 = center - r + u   # top-left
    p10 = center + r + u
    p01 = center - r - u
    p11 = center + r - u
    verts = np.stack([p00, p10, p11, p00, p11, p01]).astype(np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]],
                   np.float32)
    return verts, uvs


# -------------------------------------------------------------- Theater ---


class Theater:
    """Scene state + per-frame draw-list assembly."""

    def __init__(self, profile: Optional[EnvironmentProfile] = None,
                 scene: Optional[glb_mod.Scene] = None,
                 panorama: Optional[np.ndarray] = None,
                 aspect: float = 16.0 / 9.0, lang: str = "EN",
                 space: str = "stage", eye_height: float = EYE_HEIGHT):
        # "stage": world origin on the floor, eye at `eye_height` (the
        # reference's preferred STAGE reference space); "local": origin at
        # the head, environment shifted down (LOCAL fallback,
        # reference xr_session.py STAGE-else-LOCAL).
        self.space = space
        self.eye_height = float(eye_height)
        self.profile = profile or dark_room_profile()
        self.scene = scene
        self.panorama = panorama
        self.lang = lang
        self.ui = _default_ui()
        self.frost_strength = 0.0
        self.vendor = "generic"
        self.lasers: List[LaserBeam] = []
        self.keyboard_state = KeyboardState()
        self.keyboard_panel = PlaneSpec()
        self.keys = build_layout()
        self.kb_hover: Optional[int] = None
        self.kb_pressed: Optional[int] = None
        self.stats = {"fps": 0.0, "low1": 0.0, "latency_ms": 0.0, "model": ""}
        self._osd: Optional[Tuple[float, np.ndarray]] = None
        self._throttle_fps = OverlayThrottle(0.5)
        self._throttle_kb = OverlayThrottle(0.25)
        self._help_tex: Optional[np.ndarray] = None
        self._static_env: Optional[List[Tuple[DrawItem, np.ndarray]]] = None

        # screen pose: locked layout wins (reference environments/README.md
        # 'Screen Layout'), else the default seated pose.  seat_height lifts
        # the screen to eye level in floor-origin space.
        if self.profile.screen is not None:
            sl = self.profile.screen
            self.screen = ScreenPose(
                width=sl.width, height=sl.width / max(aspect, 1e-6),
                distance=-sl.position[2], pan_x=sl.position[0],
                pan_y=sl.position[1] - self.eye_height,
                yaw=math.radians(sl.rotation_deg[1]),
                pitch=math.radians(sl.rotation_deg[0]),
                roll=math.radians(sl.rotation_deg[2]),
                seat_height=self.origin_y)
            if sl.curve_axis != "none":
                self.ui["curved"] = True
        else:
            self.screen = ScreenPose(seat_height=self.origin_y).with_aspect(
                aspect)

    @property
    def origin_y(self) -> float:
        """World y of the seated eye (camera height for flat presenters)."""
        return self.eye_height if self.space == "stage" else 0.0

    @property
    def _env_y(self) -> float:
        """Y translation of environment geometry: floor at world y=0 in
        stage space, `eye_height` below the head in local space."""
        return 0.0 if self.space == "stage" else -self.eye_height

    # -- construction helpers ------------------------------------------------

    @classmethod
    def from_env_dir(cls, room_dir: Optional[str], aspect: float = 16 / 9,
                     lang: str = "EN") -> "Theater":
        """Load `<room_dir>/{profile.json,environment.glb,panorama}` like the
        reference's environment scan (reference environment.py:415-451)."""
        if not room_dir:
            return cls(aspect=aspect, lang=lang)
        profile = load_profile(room_dir)
        scene = None
        glb_path = os.path.join(room_dir, profile.glb)
        if os.path.isfile(glb_path):
            try:
                scene = glb_mod.load_glb(glb_path)
            except (ValueError, OSError):
                scene = None
        panorama = None
        if profile.panorama and os.path.isfile(profile.panorama):
            try:
                from PIL import Image

                panorama = np.asarray(
                    Image.open(profile.panorama).convert("RGB"), np.uint8)
            except Exception:
                panorama = None
        return cls(profile=profile, scene=scene, panorama=panorama,
                   aspect=aspect, lang=lang)

    # -- state mutation --------------------------------------------------------

    def set_aspect(self, aspect: float) -> None:
        self.screen = self.screen.with_aspect(aspect)

    def set_space(self, space: str) -> None:
        """Switch floor-origin ("stage") vs head-origin ("local") space —
        re-seats the screen and shifts the environment (reference
        xr_session.py STAGE-else-LOCAL fallback)."""
        if space == self.space:
            return
        from dataclasses import replace

        self.space = space
        self.screen = replace(self.screen, seat_height=self.origin_y)
        self._static_env = None

    def set_stats(self, fps: float, low1: float = 0.0,
                  latency_ms: float = 0.0, model: str = "") -> None:
        self.stats.update(fps=fps, low1=low1, latency_ms=latency_ms,
                          model=model)

    def show_osd(self, tex: np.ndarray, ttl: float = 2.0,
                 now: Optional[float] = None) -> None:
        """Transient OSD quad (depth/preset/crop/seat announcements)."""
        now = time.monotonic() if now is None else now
        self._osd = (now + ttl, tex)

    def set_screen(self, pose: ScreenPose) -> None:
        if self.profile.locked:
            return  # locked layouts reject grabs (reference environment.py)
        self.screen = pose

    def invalidate_static(self) -> None:
        self._static_env = None

    # -- static scene -----------------------------------------------------------

    def _env_items(self) -> List[Tuple[DrawItem, np.ndarray]]:
        """[(item, base_colors)] — base colors kept so spill can modulate."""
        if self._static_env is not None:
            return self._static_env
        items: List[Tuple[DrawItem, np.ndarray]] = []

        shift = np.array([0.0, self._env_y, 0.0], np.float32)

        if self.panorama is not None:
            sph = panorama_sphere()
            verts = sph[:, :3] + shift
            # sphere uv: u wraps longitude, v=0 bottom pole → image v flip
            uvs = np.stack([sph[:, 3], 1.0 - sph[:, 4]], axis=1)
            expo = min(self.profile.lighting.exposure, 2.0)
            cols = np.full((verts.shape[0], 4), expo, np.float32)
            cols[:, 3] = 1.0
            item = DrawItem(kind="panorama", verts=verts, uvs=uvs,
                            colors=cols,  # exposure 1..2 headroom is real;
                                          # outputs clamp at the backends
                            texture=self.panorama, depth_write=False,
                            wrap_u=True)
            items.append((item, item.colors))

        head = (0.0, self.origin_y, 0.0)
        lights = list(self.scene.lights) if self.scene is not None else []
        if self._env_y:
            lights = [glb_mod.Light(
                kind=lt.kind, color=lt.color, intensity=lt.intensity,
                position=(lt.position[0], lt.position[1] + self._env_y,
                          lt.position[2]),
                direction=lt.direction) for lt in lights]
        if self.scene is not None and self.scene.primitives:
            # GLB scenes are authored in floor-origin space; the profile's
            # model transform was applied at parse time by node matrices
            for prim in self.scene.primitives:
                pos = prim.positions + shift
                base = lit_vertex_colors(
                    pos, prim.normals, prim.base_color[:3],
                    self.profile, lights, head_pos=head)
                base[:, 3] = prim.base_color[3]
                items.append((DrawItem(
                    kind="env", verts=pos, colors=base,
                    indices=prim.indices,
                    blend="alpha" if prim.base_color[3] < 0.999 else "opaque",
                ), base))
        elif self.panorama is None:
            room = default_room()
            pos = room[:, :3] + shift
            base = lit_vertex_colors(
                pos, room[:, 3:6], (0.42, 0.42, 0.46), self.profile,
                head_pos=head)
            items.append((DrawItem(kind="env", verts=pos, colors=base),
                          base))

        self._static_env = items
        return items

    # -- frame assembly ----------------------------------------------------------

    def frame_items(self, screen_tex, *,
                    gpu: bool = False, dibr: Optional[dict] = None,
                    now: Optional[float] = None
                    ) -> Tuple[Tuple[float, float, float], List[DrawItem]]:
        """(clear_rgb, ordered draw list) for one eye/frame.

        `screen_tex`: the frame to show on the virtual screen, a numpy
        array or a tensor on any device.  Software backends pass the
        PRE-WARPED eye view; the GL backend passes the raw frame and
        supplies `dibr` uniforms (eye_offset, strength, convergence, roll)
        so the warp runs in the screen shader — the reference's division of
        labor (fragment-shader warp, viewer.py:386-631).

        The frame-derived light terms (spill, glow tint) are torch ops on
        the texture's device over its 8× subsample, read back in one small
        download of 7 floats; a texture on the card is then downloaded once,
        here, for the host rasterizer (`texture`, the frost veil)."""
        now = time.monotonic() if now is None else now
        ui = self.ui
        items: List[DrawItem] = []

        passthrough = bool(ui.get("passthrough"))
        if passthrough:
            clear = PASSTHROUGH_KEY
        else:
            clear = BACKGROUND_COLORS[int(ui.get("background", 0))
                                      % len(BACKGROUND_COLORS)]

        # frame-derived light terms, subsampled (reference frame.py computes
        # the border reduction on GPU): [spill, spill tint (3), glow tint (3)]
        light = None
        if screen_tex is not None:
            sub = screen_tex[::_SPILL_SUBSAMPLE, ::_SPILL_SUBSAMPLE]
            if isinstance(screen_tex, torch.Tensor):
                sub = sub.to(torch.float32)
            else:
                sub = torch.from_numpy(np.array(sub, np.float32))
            s, t = ambient_spill(sub, self.profile.lighting.screen_light_intensity)
            light = torch.cat([s.reshape(1), t, border_glow_color(sub)]).cpu().numpy()
            if isinstance(screen_tex, torch.Tensor):
                screen_tex = screen_tex.cpu().numpy()

        if not passthrough:
            spill, tint = (0.0, np.zeros(3, np.float32))
            if light is not None:
                spill, tint = float(light[0]), light[1:4]
            center = np.array([self.screen.pan_x,
                               self.screen.pan_y + self.screen.seat_height,
                               -self.screen.distance], np.float32)
            for item, base in self._env_items():
                if item.kind == "panorama" or spill <= 1e-6:
                    if gpu and item.uniforms.get("spill"):
                        # cached items are mutated in place below; a dark
                        # frame must not keep glowing with the last bright
                        # frame's spill
                        item.uniforms["spill"] = 0.0
                    items.append(item)
                    continue
                if gpu:
                    # mutate in place: GL backends cache VBOs by identity
                    item.uniforms.update(
                        spill=spill, spill_tint=tuple(tint),
                        screen_center=tuple(center))
                    items.append(item)
                else:
                    d2 = ((item.verts - center[None, :]) ** 2).sum(1)
                    w = spill / (1.0 + d2)
                    cols = base.copy()
                    cols[:, :3] = np.clip(
                        base[:, :3] * (1.0 + w[:, None] * tint[None, :]),
                        0.0, 1.0)
                    mod = DrawItem(**{**item.__dict__})
                    mod.colors = cols
                    items.append(mod)

        # ---- the screen ------------------------------------------------------
        curved = bool(ui.get("curved")) and (
            self.profile.screen is None or self.profile.screen.allow_curve)
        curve_axis = (self.profile.screen.curve_axis
                      if self.profile.screen is not None
                      and self.profile.screen.curve_axis != "none"
                      else "horizontal")
        if curved:
            mesh = self.screen.curved_mesh(axis=curve_axis)
            verts = mesh[:, :3]
            uvs = np.stack([mesh[:, 3], 1.0 - mesh[:, 4]], axis=1)
            mode = "strip"
        else:
            m = self.screen.model_matrix()
            local = self.screen.flat_mesh()
            verts = local[:, :3] @ m[:3, :3].T + m[:3, 3]
            uvs = np.stack([local[:, 3], 1.0 - local[:, 4]], axis=1)
            mode = "strip"
        items.append(DrawItem(
            kind="screen", verts=verts, uvs=uvs, mode=mode,
            texture=None if gpu else screen_tex,
            uniforms=dict(dibr or {})))

        # ---- glow band -------------------------------------------------------
        transparency = float(ui.get("effect_transparency", 1.0))
        if ui.get("glow") and not passthrough and light is not None \
                and transparency > 1e-3:
            band = glow_band_mesh(self.screen, curved=curved,
                                  curve_axis=curve_axis)
            cols = np.ones((band.shape[0], 4), np.float32)
            cols[:, :3] = light[None, 4:7]
            cols[:, 3] = band[:, 5] * transparency
            items.append(DrawItem(
                kind="glow", verts=band[:, :3], colors=cols, mode="strip",
                blend="additive", depth_write=False))

        # ---- frost veil ------------------------------------------------------
        if self.frost_strength > 1e-3 and screen_tex is not None \
                and not passthrough:
            lod = frost_lod(self.frost_strength)
            if gpu:
                frost_tex = None
            else:
                k = max(1, int(2 ** round(lod)))
                small = screen_tex[::k, ::k]
                frost_tex = np.repeat(np.repeat(small, k, 0), k, 1)[
                    :screen_tex.shape[0], :screen_tex.shape[1]]
            m = self.screen.model_matrix(normal_offset=0.012)
            local = self.screen.flat_mesh()
            fverts = local[:, :3] @ m[:3, :3].T + m[:3, 3]
            fuvs = np.stack([local[:, 3], 1.0 - local[:, 4]], axis=1)
            items.append(DrawItem(
                kind="frost", verts=fverts, uvs=fuvs, mode="strip",
                texture=frost_tex,
                color=(1.0, 1.0, 1.0,
                       0.85 * self.frost_strength * transparency),
                blend="alpha", depth_write=False,
                uniforms={"lod": lod}))

        # ---- keyboard --------------------------------------------------------
        if ui.get("keyboard"):
            tex = self._throttle_kb.maybe(
                render_keyboard_texture, self.keys, self.keyboard_state,
                hover=self.kb_hover, pressed=self.kb_pressed, now=now)
            x_ax, y_ax, _, pos = self.keyboard_panel.basis()
            pos = pos + np.array([0.0, self.origin_y, 0.0])  # head-relative
            kverts, kuvs = _quad(pos.astype(np.float32),
                                 x_ax.astype(np.float32),
                                 y_ax.astype(np.float32),
                                 self.keyboard_panel.half_w * 2.0,
                                 self.keyboard_panel.half_h * 2.0)
            items.append(DrawItem(kind="keyboard", verts=kverts, uvs=kuvs,
                                  texture=tex, blend="alpha",
                                  depth_write=False))

        # ---- overlays --------------------------------------------------------
        if not ui.get("overlays_hidden"):
            rot = self.screen.rotation()[:3, :3]
            right, up, fwd = rot[:, 0], rot[:, 1], rot[:, 2]
            center = np.array([self.screen.pan_x,
                               self.screen.pan_y + self.screen.seat_height,
                               -self.screen.distance], np.float32)
            if ui.get("fps_overlay"):
                tex = self._throttle_fps.maybe(
                    fps_panel, self.stats["fps"], self.stats["low1"],
                    self.stats["latency_ms"], self.stats["model"], now=now)
                self._add_panel(items, tex, center, right, up, fwd,
                                anchor=(-0.42, 0.42), width_m=0.8)
            if ui.get("help_panel"):
                if self._help_tex is None:
                    self._help_tex = render_help_panel(self.lang)
                self._add_panel(items, self._help_tex, center, right, up,
                                fwd, anchor=(0.0, 0.0), width_m=1.6,
                                forward=0.35)
            if self._osd is not None:
                expiry, tex = self._osd
                if now >= expiry:
                    self._osd = None
                else:
                    self._add_panel(items, tex, center, right, up, fwd,
                                    anchor=(0.0, -0.38), width_m=0.7)

        # ---- lasers + controllers -------------------------------------------
        for beam in self.lasers:
            if not beam.visible:
                continue
            items.extend(self._beam_items(beam))
            items.append(self._controller_item(beam))

        return clear, items

    # -- internals ----------------------------------------------------------

    def _add_panel(self, items: List[DrawItem], tex: np.ndarray,
                   center: np.ndarray, right: np.ndarray, up: np.ndarray,
                   fwd: np.ndarray, anchor: Tuple[float, float],
                   width_m: float, forward: float = 0.03) -> None:
        h_m = width_m * tex.shape[0] / max(tex.shape[1], 1)
        pos = (center + right * (anchor[0] * self.screen.width)
               + up * (anchor[1] * self.screen.height) + fwd * forward)
        verts, uvs = _quad(pos, right, up, width_m, h_m)
        items.append(DrawItem(kind="overlay", verts=verts, uvs=uvs,
                              texture=tex, blend="alpha",
                              depth_write=False))

    def _beam_items(self, beam: LaserBeam) -> List[DrawItem]:
        o = np.asarray(beam.origin, np.float32)
        d = np.asarray(beam.direction, np.float32)
        d = d / max(np.linalg.norm(d), 1e-9)
        t = float(beam.hit.t) if beam.hit is not None else min(BEAM_MAX, 8.0)
        end = o + d * t
        upw = np.array([0.0, 1.0, 0.0], np.float32)
        u1 = np.cross(d, upw)
        if np.linalg.norm(u1) < 1e-6:
            u1 = np.array([1.0, 0.0, 0.0], np.float32)
        u1 /= np.linalg.norm(u1)
        u2 = np.cross(d, u1)
        col = BEAM_COLORS.get(beam.hand, (0.8, 0.8, 0.9))
        out: List[DrawItem] = []
        for axis in (u1, u2):
            w0, w1 = 0.004, 0.0015  # taper
            verts = np.stack([
                o - axis * w0, o + axis * w0, end + axis * w1,
                o - axis * w0, end + axis * w1, end - axis * w1,
            ]).astype(np.float32)
            cols = np.ones((6, 4), np.float32)
            cols[:, :3] = col
            cols[:, 3] = [0.8, 0.8, 0.3, 0.8, 0.3, 0.3]
            out.append(DrawItem(kind="beam", verts=verts, colors=cols,
                                blend="additive", depth_write=False))
        if beam.hit is not None:
            out.append(self._hit_circle(end, col))
        return out

    def _hit_circle(self, p: np.ndarray,
                    col: Tuple[float, float, float]) -> DrawItem:
        rot = self.screen.rotation()[:3, :3]
        right, up, nrm = rot[:, 0], rot[:, 1], rot[:, 2]
        p = p + nrm * 0.004
        r_in, r_out, segs = 0.008, 0.014, 12
        verts = []
        for i in range(segs):
            a0 = 2 * math.pi * i / segs
            a1 = 2 * math.pi * (i + 1) / segs
            def rim(a, r):
                return p + (right * math.cos(a) + up * math.sin(a)) * r
            quad = [rim(a0, r_in), rim(a1, r_in), rim(a1, r_out),
                    rim(a0, r_in), rim(a1, r_out), rim(a0, r_out)]
            verts.extend(quad)
        cols = np.ones((len(verts), 4), np.float32)
        cols[:, :3] = col
        cols[:, 3] = 0.9
        return DrawItem(kind="hit", verts=np.asarray(verts, np.float32),
                        colors=cols, blend="additive", depth_write=False)

    def _controller_item(self, beam: LaserBeam) -> DrawItem:
        verts, norms, cols = controller_mesh(self.vendor, beam.hand)
        d = np.asarray(beam.direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-9)
        z = -d
        upw = np.array([0.0, 1.0, 0.0])
        x = np.cross(upw, z)
        if np.linalg.norm(x) < 1e-6:
            x = np.array([1.0, 0.0, 0.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        rot = np.stack([x, y, z], axis=1).astype(np.float32)
        world = verts @ rot.T + np.asarray(beam.origin, np.float32)
        wn = norms @ rot.T
        # simple headlight shade toward the seated EYE (origin_y up —
        # aiming at the floor origin inverted the shading on controllers
        # held at chest height)
        eye = np.array([0.0, self.origin_y, 0.0], np.float32)
        to_head = eye[None, :] - world
        to_head /= np.maximum(
            np.linalg.norm(to_head, axis=1, keepdims=True), 1e-6)
        ndl = np.maximum((wn * to_head).sum(1, keepdims=True), 0.0)
        shade = cols.copy()
        shade[:, :3] = np.clip(cols[:, :3] * (0.35 + 0.65 * ndl), 0.0, 1.0)
        return DrawItem(kind="controller", verts=world, colors=shade)
