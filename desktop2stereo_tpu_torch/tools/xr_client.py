"""Workstation XR/stereo client: renders the xr/net.py frame protocol.

Port of `desktop2stereo_tpu/tools/xr_client.py`.  The per-eye DIBR warp of
the flat and theater paths runs in PyTorch on `--device` (default `cuda`;
`cpu` runs the kernels' plain versions; without a card the client exits 2
naming CUDA, with no CPU fallback): the model-resolution depth is upsampled
by the client's own half-pixel bilinear, each eye goes through
`ops/stereo.dibr_render` (kernel K5 at roll 0, the 2-D plain path with a
roll), and the stereo frame is arranged and rounded to uint8 on the device
before one download.

The counterpart of `sinks/xr.py`: that sink publishes (rgb, depth) from
the pipeline's host; THIS program runs on the user's workstation, polls
frames, performs the per-eye DIBR warp at render time (the job the
reference does in its viewer fragment shader, reference viewer.py:386-631,
and per-eye in OpenXR, reference xr_viewer/implementation.py:1724-2063),
and presents:

- ``--present openxr`` pyopenxr headset session: per-eye swapchain render
  loop (wait_frame → begin_frame → locate_views → render → end_frame)
  driven by the xr/session.py state machine (reference
  xr_viewer/implementation.py:1724-2063, xr_session.py:117-226);
- ``--present glfw``  PyOpenGL + GLFW window, warp in a GLSL shader (a
  compact port of the same DIBR math — parallax shift, 3-tap pre-smooth,
  edge falloff, disocclusion confidence, directional background inpaint,
  border alpha clip, rounded-corner SDF, roll-aware parallax);
- ``--present cv``    OpenCV window, torch warp on `--device`;
- ``--present png``   offscreen PNG frames, torch warp on `--device`;
- ``--present auto``  first of glfw/cv/png that imports (openxr stays
  explicit — a flat window should not race a headset runtime).

Usage:
    python -m desktop2stereo_tpu_torch.tools.xr_client --host <server> --port 1123
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from desktop2stereo_tpu_torch.cli import DEVICES, device_policy
from desktop2stereo_tpu_torch.ops.stereo import dibr_render
from desktop2stereo_tpu_torch.xr.filters import OneEuroFilter
from desktop2stereo_tpu_torch.xr.geometry import ScreenPose
from desktop2stereo_tpu_torch.xr.net import FrameNetClient


# --------------------------------------------------------------------------
# Per-eye DIBR warp on the device
# --------------------------------------------------------------------------

def to_device(x, device) -> torch.Tensor:
    """A numpy array or a tensor → a tensor on `device`, dtype kept (a
    uint8 frame uploads as uint8)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=("C", "W")))
    return x.to(device)


def _resize_bilinear(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """half-pixel-centered bilinear resize (torch F.interpolate
    align_corners=False semantics — the GL sampler's filtering of a
    model-res depth texture, reference frame.py:44-57) of img [h, w], as
    index gathers on img's device."""
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img
    f32, dev = torch.float32, img.device
    ys = (torch.arange(H, dtype=f32, device=dev) + 0.5) * (h / H) - 0.5
    xs = (torch.arange(W, dtype=f32, device=dev) + 0.5) * (w / W) - 0.5
    y0 = ys.floor().long().clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    fy = (ys - y0).clamp(0.0, 1.0)[:, None]
    fx = (xs - x0).clamp(0.0, 1.0)[None, :]
    top, bot = img[y0], img[y1]
    a, b, c, d = top[:, x0], top[:, x1], bot[:, x0], bot[:, x1]
    return ((a * (1 - fx) + b * fx) * (1 - fy)
            + (c * (1 - fx) + d * fx) * fy)


def warp_eye(
    rgb: torch.Tensor,          # [H,W,3] 0..255
    depth: torch.Tensor,        # [h,w] in [0,1] (1 = near), any resolution
    eye_offset: float,          # ±ipd/2 in UV units
    depth_strength: float = 1.0,
    convergence: float = 0.0,
    search_radius: int = 12,
    depth_tolerance: float = 0.012,
    edge_margin: float = 0.05,
    roll: float = 0.0,
) -> torch.Tensor:
    """One eye of the DIBR warp, [H,W,3] f32 on rgb's device: parallax
    gather + soft disocclusion blend with directional background inpaint
    (reference viewer.py:528-631 behavior) through `ops/stereo.dibr_render`
    — kernel K5 at roll 0.  `roll` rotates the parallax direction
    (reference u_roll, viewer.py:399).  In f32 end to end, as the JAX
    client is."""
    H, W = rgb.shape[0], rgb.shape[1]
    depth = depth.to(torch.float32)
    if tuple(depth.shape) != (H, W):
        # the server ships MODEL-res depth (its bilinear upsample IS the
        # full-res map — sinks/xr.py); sample it at frame res like the GL
        # depth texture would be
        depth = _resize_bilinear(depth, H, W)
    return dibr_render(rgb.to(torch.float32), depth, eye_offset, depth_strength,
                       convergence, search_radius, depth_tolerance, edge_margin,
                       roll)


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """0..255 float → uint8 as the client rounds: +0.5, clip, truncate."""
    return (x + 0.5).clamp(0, 255).to(torch.uint8)


def arrange_sbs(left: torch.Tensor, right: torch.Tensor,
                mode: str = "Full-SBS") -> torch.Tensor:
    """Two f32 eyes → the uint8 side-by-side frame.  Half-SBS pair-means
    the full-width eyes' columns (an odd width drops its last column)."""
    if mode == "Half-SBS":
        if left.shape[1] % 2:  # odd width (window capture): drop last col
            left, right = left[:, :-1], right[:, :-1]
        left = (left[:, 0::2] + left[:, 1::2]) * 0.5
        right = (right[:, 0::2] + right[:, 1::2]) * 0.5
    return round_u8(torch.cat([left, right], dim=1))


def render_stereo(
    rgb_u8, depth,
    ipd: float, depth_strength: float, convergence: float,
    mode: str = "Full-SBS", roll: float = 0.0, device="cuda",
) -> torch.Tensor:
    """(rgb, depth) → displayable stereo frame, a uint8 tensor on `device`.
    `rgb_u8` [H,W,3] and `depth` [h,w] (any resolution, or None: no warp)
    are numpy arrays or tensors; they are moved to `device` first."""
    rgb = to_device(rgb_u8, device).to(torch.float32)
    if depth is None:
        left = right = rgb
    else:
        # one upsample serves both eyes (warp_eye samples it no further)
        dep = _resize_bilinear(to_device(depth, device).to(torch.float32),
                               rgb.shape[0], rgb.shape[1])
        left = warp_eye(rgb, dep, -ipd / 2, depth_strength, convergence,
                        roll=roll)
        right = warp_eye(rgb, dep, +ipd / 2, depth_strength, convergence,
                         roll=roll)
    return arrange_sbs(left, right, mode)


# --------------------------------------------------------------------------
# Presenters
# --------------------------------------------------------------------------

class PngPresenter:
    """Headless: write every frame to out_dir/frame_%05d.png."""

    gpu_warp = False

    def __init__(self, out_dir: str = "xr_frames"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.count = 0

    def push(self, sbs_u8: np.ndarray) -> bool:
        from PIL import Image

        path = os.path.join(self.out_dir, f"frame_{self.count:05d}.png")
        Image.fromarray(sbs_u8).save(path)
        self.count += 1
        return True

    def close(self) -> None:
        pass


class CvPresenter:
    """OpenCV window (torch warp on --device)."""

    gpu_warp = False

    def __init__(self, title: str = "desktop2stereo XR client"):
        import cv2

        if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
                or os.name == "nt"):
            # fail HERE so --present auto falls through to the png
            # presenter on headless hosts (imshow would only fail later)
            raise RuntimeError("no display for the OpenCV presenter")
        self._cv = cv2
        self.title = title

    def push(self, sbs_u8: np.ndarray) -> bool:
        self._cv.imshow(self.title, sbs_u8[..., ::-1])
        return (self._cv.waitKey(1) & 0xFF) not in (27, ord("q"))

    def close(self) -> None:
        self._cv.destroyAllWindows()


# The DIBR warp shader + GL draw-list backend live in xr/gl_theater.py
# (shared with the OpenXR swapchain path); the scene policy lives in
# xr/theater.py.  `_DIBR_FRAG` stays as an alias for introspection.
from desktop2stereo_tpu_torch.xr.gl_theater import DIBR_FRAG as _DIBR_FRAG  # noqa: E402


# Physical half-IPD for the theater camera separation (metres); the warp's
# `ipd` CLI knob stays in UV units like the reference's shader uniform.
_CAMERA_HALF_IPD_M = 0.032
_THEATER_FOV_DEG = 75.0

# keyboard → ui_state toggles (theater mode); mirrors the in-headset chords
_THEATER_KEYS = {
    "F": "fps_overlay", "H": "help_panel", "K": "keyboard", "G": "glow",
    "P": "passthrough", "C": "curved", "O": "overlays_hidden",
}


def _fullscreen_screen_item(dibr: dict) -> "DrawItem":
    """NDC fullscreen quad running the DIBR warp (the classic two-viewport
    mode, reference viewer.py:2551+) — identity view/proj."""
    from desktop2stereo_tpu_torch.xr.raster import DrawItem

    verts = np.array([[-1, -1, 0], [1, -1, 0], [-1, 1, 0], [1, 1, 0]],
                     np.float32)
    uvs = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    return DrawItem(kind="screen", verts=verts, uvs=uvs, mode="strip",
                    depth_test=False, uniforms=dibr)


class GlfwPresenter:
    """PyOpenGL + GLFW window.

    Theater mode (default): the full virtual theater — environment room or
    GLB scene, panorama, screen-in-a-room with the DIBR warp evaluated on
    the screen mesh, glow/frost/overlay/keyboard quads and laser beams per
    xr/theater.py (the reference's in-headset composition rendered to a
    flat window, reference xr_viewer/implementation.py:1880-2045).  With
    `theater=None` it renders the classic two-viewport fullscreen warp
    (reference viewer.py:2551+).

    Keys: q/ESC quit; in theater mode F fps panel, H help, K keyboard,
    G glow, P passthrough, C curved screen, O hide overlays, B background
    cycle."""

    gpu_warp = True

    def __init__(self, ipd: float, depth_strength: float, convergence: float,
                 size: Tuple[int, int] = (1280, 720),
                 title: str = "desktop2stereo XR client",
                 roll: float = 0.0, corner_radius: float = 0.0,
                 theater=None):
        import glfw

        from desktop2stereo_tpu_torch.xr.gl_theater import TheaterGL

        self.roll = roll
        self.corner_radius = corner_radius
        self.theater = theater

        if not glfw.init():
            raise RuntimeError("glfw.init failed")
        glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 3)
        glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 3)
        glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_CORE_PROFILE)
        self._glfw = glfw
        self._win = glfw.create_window(size[0], size[1], title, None, None)
        if self._win is None:
            glfw.terminate()
            raise RuntimeError("glfw window creation failed")
        glfw.make_context_current(self._win)
        self.gl = TheaterGL()
        self.params = (ipd, depth_strength, convergence)
        self._fps_t = time.perf_counter()
        self._fps_ema = 0.0
        glfw.set_key_callback(self._win, self._on_key)

    def _on_key(self, _win, key, _scancode, action, _mods) -> None:
        glfw = self._glfw
        if action != glfw.PRESS:
            return
        if key in (glfw.KEY_Q, glfw.KEY_ESCAPE):
            glfw.set_window_should_close(self._win, True)
        if self.theater is None:
            return
        ui = self.theater.ui
        name = glfw.get_key_name(key, 0)
        toggle = _THEATER_KEYS.get((name or "").upper())
        if toggle:
            ui[toggle] = not ui[toggle]
        elif (name or "").upper() == "B":
            ui["background"] = (int(ui["background"]) + 1) % 6

    def push_packet(self, rgb: np.ndarray, depth: Optional[np.ndarray]) -> bool:
        glfw = self._glfw
        if glfw.window_should_close(self._win):
            return False
        ipd, strength, conv = self.params
        self.gl.set_frame(rgb, depth)
        fw, fh = glfw.get_framebuffer_size(self._win)
        now = time.perf_counter()
        dt = max(now - self._fps_t, 1e-6)
        self._fps_t = now
        self._fps_ema = 0.9 * self._fps_ema + 0.1 / dt
        th = self.theater
        if th is not None:
            th.set_stats(self._fps_ema, latency_ms=dt * 1000.0)
            if abs(th.screen.width / max(th.screen.height, 1e-6)
                   - rgb.shape[1] / rgb.shape[0]) > 1e-3:
                th.set_aspect(rgb.shape[1] / rgb.shape[0])
        from desktop2stereo_tpu_torch.xr.raster import symmetric_proj, view_translate

        ident = np.eye(4, np.float32)
        for eye, vp in ((-1, (0, 0, fw // 2, fh)),
                        (+1, (fw // 2, 0, fw - fw // 2, fh))):
            dibr = {"eye_offset": eye * ipd / 2, "strength": strength,
                    "convergence": conv, "roll": self.roll,
                    "corner_radius": self.corner_radius}
            if th is None:
                self.gl.render(vp, (0.0, 0.0, 0.0),
                               [_fullscreen_screen_item(dibr)], ident, ident)
            else:
                clear, items = th.frame_items(rgb, gpu=True, dibr=dibr)
                view = view_translate(
                    (eye * _CAMERA_HALF_IPD_M, th.origin_y, 0.0))
                proj = symmetric_proj(
                    _THEATER_FOV_DEG, max(vp[2], 1) / max(vp[3], 1))
                self.gl.render(vp, clear, items, view, proj)
        glfw.swap_buffers(self._win)
        glfw.poll_events()
        return True

    def close(self) -> None:
        self._glfw.terminate()


# --------------------------------------------------------------------------
# OpenXR presenter (headset path)
# --------------------------------------------------------------------------

def _quat_forward(q_xyzw) -> np.ndarray:
    """-Z basis vector of a unit quaternion's rotation (the OpenXR aim
    pose's pointing direction)."""
    x, y, z, w = q_xyzw
    fwd = np.array([
        -(2.0 * (x * z + w * y)),
        -(2.0 * (y * z - w * x)),
        -(1.0 - 2.0 * (x * x + y * y)),
    ], np.float64)
    n = np.linalg.norm(fwd)
    return fwd / n if n > 1e-9 else np.array([0.0, 0.0, -1.0])


def head_roll(orientation_xyzw) -> float:
    """In-plane roll (radians) of a view pose quaternion: the angle the
    head's RIGHT axis makes with world-horizontal — the rotation the
    parallax direction must follow (reference viewer.py:399 u_roll fed
    from the screen/head roll)."""
    x, y, z, w = (float(v) for v in orientation_xyzw)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r10 = 2.0 * (x * y + w * z)
    import math

    return math.atan2(r10, r00)


class XrView:
    """One eye's located view for a frame (pose + fov)."""

    def __init__(self, orientation_xyzw=(0.0, 0.0, 0.0, 1.0),
                 position=(0.0, 0.0, 0.0), fov=(-0.8, 0.8, 0.8, -0.8)):
        self.orientation = tuple(orientation_xyzw)
        self.position = tuple(position)
        self.fov = tuple(fov)  # (left, right, up, down) half-angles, rad


class OpenXRPresenter:
    """Headset presenter: the full OpenXR frame loop driven through the
    runtime-agnostic session FSM (xr/session.py SessionManager).

    Per frame (reference xr_viewer/implementation.py:1724-2063):
    poll events → wait_frame → begin_frame → locate_views → per-eye
    acquire/render(DIBR at the view's roll)/release → end_frame.  The
    runtime behind it is the pyopenxr adapter (`_PyOpenXRRuntime`) on a
    real headset, or any object with the same five frame-loop methods —
    which is how the mocked-runtime test drives one complete frame
    through the REAL state machine without a headset.
    """

    gpu_warp = True

    def __init__(self, ipd: float, depth_strength: float, convergence: float,
                 runtime=None, wait_attempts: Optional[int] = None,
                 corner_radius: float = 0.0, theater=None, input_sink=None):
        from desktop2stereo_tpu_torch.xr.session import SessionManager, SessionPhase
        from desktop2stereo_tpu_torch.xr.theater import Theater

        self._SessionPhase = SessionPhase
        if runtime is None:
            runtime = _PyOpenXRRuntime(corner_radius=corner_radius)
        self.runtime = runtime
        self.ipd = ipd
        self.strength = depth_strength
        self.convergence = convergence
        self.session = SessionManager(runtime)
        # the theater owns the virtual-screen pose, ui toggles, lasers and
        # overlay state; runtimes that render (the real _PyOpenXRRuntime)
        # read it duck-typed via `runtime.theater`
        self.theater = theater if theater is not None else Theater()
        runtime.theater = self.theater
        # in-headset control surface: runtimes that can sample controllers
        # (duck-typed `sample_controllers()`) feed the chord router each
        # frame; actions mutate the live stereo/geometry knobs below
        from desktop2stereo_tpu_torch.xr.controls import ChordRouter

        self._chords = ChordRouter()
        self._strength_default = depth_strength
        self._strength_stash: Optional[float] = None
        self._preset_idx = 0
        self._last_input_t = time.perf_counter()
        # ui toggles live in the theater so chords change rendered pixels
        # through ONE state source (xr/theater.py consumes them directly)
        self.ui_state = self.theater.ui
        info = self.session.wait_for_device(
            should_stop=lambda: False, sleep=time.sleep,
            max_attempts=wait_attempts)
        if info is None:
            raise RuntimeError("no XR headset appeared (runtime probe)")
        self.session.bring_up()
        # LOCAL reference space puts the origin at the head, not the floor;
        # the theater shifts the environment accordingly
        from desktop2stereo_tpu_torch.xr.session import ReferenceSpace

        self.theater.set_space(
            "local" if self.session.space == ReferenceSpace.LOCAL
            else "stage")
        self.frames_rendered = 0
        self._fps_t = time.perf_counter()
        self._fps_ema = 0.0
        # OS-input loop: laser → cursor/click/scroll/keys shipped to the
        # capture host (reference input_handler.py → input.py end-to-end)
        self.input_sink = input_sink
        self._input_router = None
        self._hand_inputs = {}
        self._axes = {"sx": 0.0, "sy": 0.0, "ax": 0.0, "ay": 0.0}
        self._frame_size = (1920, 1080)

    @property
    def screen(self) -> ScreenPose:
        """The virtual screen pose — owned by the theater (locked
        environment layouts reject writes, reference environment.py)."""
        return self.theater.screen

    @screen.setter
    def screen(self, pose: ScreenPose) -> None:
        self.theater.set_screen(pose)

    def push_packet(self, rgb: np.ndarray, depth: Optional[np.ndarray]) -> bool:
        SP = self._SessionPhase
        for phase in self.runtime.poll_phase_events():
            self.session.on_state(phase)
        if self.session.phase in (SP.STOPPING, SP.EXITING):
            return False
        # wait/begin/end_frame are only legal while the session runs
        # (after the runtime's READY event triggered begin_session);
        # until then stay alive and drop the frame — latest-wins semantics
        # mean the next packet renders fresh anyway
        if not getattr(self.runtime, "running", True):
            return True
        self._frame_size = (rgb.shape[1], rgb.shape[0])
        self._route_controller_input()
        # OpenXR requires wait/begin/end every frame even when not visible
        display_time, render_hint = self.runtime.wait_frame()
        self.runtime.begin_frame()
        rendered = False
        if self.session.should_render and render_hint:
            views = self.runtime.locate_views(display_time)
            for eye, view in enumerate(views):
                # parallax direction follows head roll relative to the
                # virtual screen's own roll (reference viewer.py:544-556)
                roll = head_roll(view.orientation) - self.screen.roll
                eye_offset = (eye * 2 - 1) * self.ipd / 2.0
                self.runtime.render_eye(
                    eye, rgb, depth, view,
                    eye_offset=eye_offset, strength=self.strength,
                    convergence=self.convergence, roll=roll)
            rendered = True
            self.frames_rendered += 1
            now = time.perf_counter()
            dt = max(now - self._fps_t, 1e-6)
            self._fps_t = now
            self._fps_ema = 0.9 * self._fps_ema + 0.1 / dt
            self.theater.set_stats(self._fps_ema, latency_ms=dt * 1000.0)
        self.runtime.end_frame(display_time, rendered)
        return True

    def _route_controller_input(self) -> None:
        """Sample controllers (when the runtime can) and apply the chord
        router's actions to the live knobs (reference readme.md:193-244;
        the per-frame application mirrors input_handler.py's step
        constants)."""
        sample = getattr(self.runtime, "sample_controllers", None)
        if sample is None:
            return
        # the runtime needs the live screen pose for laser → screen hits
        self.runtime.screen_pose = self.screen
        state = sample()
        now = time.perf_counter()
        dt = min(max(now - self._last_input_t, 0.0), 0.1)
        self._last_input_t = now
        self._update_lasers(state)
        if state is None:
            return
        self._axes = {"sx": 0.0, "sy": 0.0, "ax": 0.0, "ay": 0.0}
        for act in self._chords.update(state):
            self._apply_action(act, dt)
        self._route_os_input(state, dt)

    def _route_os_input(self, state, dt: float) -> None:
        """Feed the per-hand ray/trigger state through the OS-input router
        and ship the events to the capture host (the reference's
        laser-drives-the-desktop loop, input_handler.py:31-2046)."""
        if self.input_sink is None:
            return
        from desktop2stereo_tpu_torch.xr.input_router import OsInputRouter

        if self._input_router is None:
            self._input_router = OsInputRouter(
                self._frame_size, keyboard_state=self.theater.keyboard_state)
        self._input_router.set_frame_size(*self._frame_size)
        hands = dict(self._hand_inputs)
        for hand, trig in (("left", state.trigger_l),
                           ("right", state.trigger_r)):
            if hand in hands:
                hands[hand].trigger = float(trig)
        events = self._input_router.update(
            hands, scroll_xy=(self._axes["sx"], self._axes["sy"]),
            arrow_xy=(self._axes["ax"], self._axes["ay"]), dt=dt)
        # surface the pressed key in the keyboard texture
        self.theater.kb_pressed = None
        rs = self._input_router.state
        if rs.pressed_vk is not None:
            for i, key in enumerate(self.theater.keys):
                if key.vk == rs.pressed_vk:
                    self.theater.kb_pressed = i
                    break
            rs.pressed_vk = None
        if events:
            try:
                self.input_sink(events)
            except Exception:
                pass  # input is best-effort; frames keep flowing

    def _update_lasers(self, state) -> None:
        """Mirror the runtime's aim poses into the theater (beams +
        controller models + keyboard hover) and enrich the chord state's
        keyboard-hover flags (reference laser.py beam render +
        input_handler.py ownership)."""
        from desktop2stereo_tpu_torch.xr.input_router import HandInput
        from desktop2stereo_tpu_torch.xr.keyboard import hit_key
        from desktop2stereo_tpu_torch.xr.laser import (ray_panel_hit, ray_plane_uv,
                                                 ray_screen_hit)
        from desktop2stereo_tpu_torch.xr.theater import LaserBeam

        th = self.theater
        aims = getattr(self.runtime, "last_aim", None)
        th.lasers = []
        th.kb_hover = None
        self._hand_inputs = {}
        if not aims:
            return
        for hand, (origin, direction) in aims.items():
            hand_name = "left" if hand == "l" else "right"
            hi = HandInput()
            hit = ray_screen_hit(origin, direction, self.screen,
                                 curved=bool(th.ui.get("curved")))
            th.lasers.append(LaserBeam(
                hand_name, np.asarray(origin), np.asarray(direction),
                hit=hit))
            if hit is not None:
                hi.screen_uv = (hit.u, hit.v)
                hi.screen_dist = hit.t
            plane = ray_plane_uv(origin, direction, self.screen)
            if plane is not None:
                hi.plane_uv = (plane[0], plane[1])
            if th.ui.get("keyboard"):
                from dataclasses import replace as _replace

                # the keyboard quad renders at head height (theater adds
                # origin_y); hit-test the same world-space panel
                panel = _replace(th.keyboard_panel,
                                 pan_y=th.keyboard_panel.pan_y + th.origin_y)
                ph = ray_panel_hit(origin, direction, panel)
                if ph is not None:
                    ki = hit_key(th.keys, ph[0], ph[1])
                    if ki is not None:
                        th.kb_hover = ki
                        hi.kb_key = th.keys[ki]
                        hi.kb_dist = ph[2]
                        if state is not None:
                            if hand == "l":
                                state.keyboard_hover_l = True
                            else:
                                state.keyboard_hover_r = True
            self._hand_inputs[hand_name] = hi

    def _apply_action(self, act, dt: float) -> None:
        from dataclasses import replace

        sc = self.screen
        k, v = act.kind, act.value
        if k == "depth_scale":
            # reference: Right grip + Left stick Y, range 0–10
            self.strength = float(np.clip(self.strength + v * 2.0 * dt,
                                          0.0, 10.0))
            self._osd_depth()
        elif k == "depth_ratio_fine":
            self.strength = float(np.clip(self.strength + v * 0.5 * dt,
                                          0.0, 10.0))
            self._osd_depth()
        elif k == "reset_depth_scale":
            self.strength = 2.0  # the reference's fixed reset value
        elif k == "reset_depth_ratio":
            self.strength = self._strength_default
        elif k == "toggle_depth_zero":
            if self._strength_stash is None:
                self._strength_stash, self.strength = self.strength, 0.0
            else:
                self.strength = self._strength_stash
                self._strength_stash = None
        elif k == "screen_width":
            f = float(np.clip(1.0 + v * 0.8 * dt, 0.5, 2.0))
            self.screen = replace(sc, width=float(np.clip(sc.width * f, 0.5, 12.0)),
                                  height=float(np.clip(sc.height * f, 0.3, 8.0)))
        elif k == "screen_distance":
            # accelerated curve (reference readme.md:199)
            self.screen = replace(sc, distance=float(
                np.clip(sc.distance + v * abs(v) * 3.0 * dt, 0.5, 15.0)))
        elif k == "screen_translate_x":
            self.screen = replace(sc, pan_x=sc.pan_x + v * 1.5 * dt)
        elif k == "screen_translate_y":
            self.screen = replace(sc, pan_y=sc.pan_y + v * 1.5 * dt)
        elif k == "screen_yaw":
            self.screen = replace(sc, yaw=sc.yaw + v * 1.0 * dt)
        elif k == "screen_pitch":
            self.screen = replace(sc, pitch=sc.pitch + v * 1.0 * dt)
        elif k == "reset_screen_pose":
            self.screen = replace(sc, pan_x=0.0, pan_y=0.0, yaw=0.0,
                                  pitch=0.0, roll=0.0,
                                  distance=ScreenPose().distance)
        elif k == "reset_screen_orientation":
            # preserve distance/size (reference readme.md:201)
            self.screen = replace(sc, yaw=0.0, pitch=0.0, roll=0.0)
        elif k == "cycle_screen_preset":
            self._preset_idx += 1
            self.screen = sc.with_preset(self._preset_idx)
            from desktop2stereo_tpu_torch.xr.geometry import SCREEN_PRESETS
            from desktop2stereo_tpu_torch.xr.overlay import preset_osd

            i = self._preset_idx % len(SCREEN_PRESETS)
            self.theater.show_osd(preset_osd(
                SCREEN_PRESETS[i][0], i, len(SCREEN_PRESETS),
                self.theater.lang))
        elif k == "cycle_controller_brand":
            from desktop2stereo_tpu_torch.xr.controller_models import next_vendor
            from desktop2stereo_tpu_torch.xr.overlay import render_text_panel

            self.theater.vendor = next_vendor(self.theater.vendor)
            self.theater.show_osd(render_text_panel(
                [f"Controller: {self.theater.vendor}"], width=300,
                font_size=20))
        elif k == "toggle_screen_curve":
            self.ui_state["curved"] = not self.ui_state["curved"]
        elif k == "cycle_background":
            self.ui_state["background"] = (self.ui_state["background"] + 1) % 5
        elif k == "effect_transparency":
            self.ui_state["effect_transparency"] = float(np.clip(
                self.ui_state["effect_transparency"] + v * 1.0 * dt, 0.0, 1.0))
        elif k == "toggle_fps_overlay":
            self.ui_state["fps_overlay"] = not self.ui_state["fps_overlay"]
        elif k == "toggle_help_panel":
            self.ui_state["help_panel"] = not self.ui_state["help_panel"]
        elif k == "toggle_keyboard":
            self.ui_state["keyboard"] = not self.ui_state["keyboard"]
        elif k == "toggle_glow_mode":
            self.ui_state["glow"] = not self.ui_state["glow"]
        elif k == "toggle_passthrough":
            self.ui_state["passthrough"] = not self.ui_state["passthrough"]
        elif k == "toggle_all_overlays":
            self.ui_state["overlays_hidden"] = (
                not self.ui_state["overlays_hidden"])
        elif k == "mouse_scroll_x":
            self._axes["sx"] = v
        elif k == "mouse_scroll_y":
            self._axes["sy"] = v
        elif k == "arrow_x":
            self._axes["ax"] = v
        elif k == "arrow_y":
            self._axes["ay"] = v
        # crop_mode / crop_adjust / calibration / seat_adjust keep their
        # state inside the chord router; drag_screen needs the aim-pose ray
        # and is applied by the runtime's grab helper (xr/geometry.py).
        # The stashed axes feed the OS-input router's scroll/arrow
        # accumulators after chord routing (_route_os_input).

    def _osd_depth(self) -> None:
        """Depth-strength OSD, re-rendered only on visible change (the
        reference throttles its PIL OSDs the same way)."""
        q = round(self.strength, 1)
        if q != getattr(self, "_osd_strength_q", None):
            from desktop2stereo_tpu_torch.xr.overlay import depth_osd

            self._osd_strength_q = q
            self.theater.show_osd(depth_osd(q, self.theater.lang))

    def close(self) -> None:
        self.session.tear_down()


class _PyOpenXRRuntime:
    """pyopenxr + PyOpenGL adapter: implements BOTH the SessionManager's
    RuntimeAdapter (probe/create/destroy/suggest) and the presenter's
    frame-loop interface against a real OpenXR runtime (SteamVR/Monado).

    Session bring-up mirrors the reference's sequence (reference
    xr_viewer/xr_session.py:117-226): instance with KHR_opengl_enable, HMD
    system, GL session binding from a hidden GLFW context, per-eye sRGB
    swapchains at the recommended size.  Frames render the FULL virtual
    theater (xr/theater.py draw lists — environment, screen DIBR warp,
    effects, lasers, overlays; reference implementation.py:1880-2045) into
    each acquired swapchain image via the xr/gl_theater.py backend, using
    the located view's pose/fov matrices (reference render.py:981-1054).
    """

    def __init__(self, corner_radius: float = 0.0):
        try:
            import xr  # pyopenxr
        except ImportError as e:  # degrade cleanly: no headset stack here
            raise RuntimeError(
                "pyopenxr is not installed — `pip install pyopenxr` on the "
                "workstation to use --present openxr") from e
        import glfw

        self._xr = xr
        self._glfw = glfw
        self.theater = None        # set by OpenXRPresenter
        self.corner_radius = corner_radius
        self.instance = xr.create_instance(xr.InstanceCreateInfo(
            enabled_extension_names=[xr.KHR_OPENGL_ENABLE_EXTENSION_NAME],
        ))
        self.system_id = None
        self.session = None
        self.swapchains = []       # per eye
        self.space = None
        self._action_set = None    # built in create_session
        self._actions_attached = False
        self._last_display_time = None
        self._aim_spaces = {}
        self._gl = None            # (ctx, prog, vao, fbo machinery)
        self._phase_map = None
        self._running = False      # begin_session .. end_session window

    # ---- RuntimeAdapter (session FSM) ------------------------------------

    def probe_system(self):
        from desktop2stereo_tpu_torch.xr.session import ReferenceSpace, SystemInfo

        xr = self._xr
        try:
            self.system_id = xr.get_system(
                self.instance,
                xr.SystemGetInfo(form_factor=xr.FormFactor.HEAD_MOUNTED_DISPLAY),
            )
        except Exception:
            return None  # headset not (yet) present: hot-wait retries
        views = xr.enumerate_view_configuration_views(
            self.instance, self.system_id,
            xr.ViewConfigurationType.PRIMARY_STEREO)
        w = int(views[0].recommended_image_rect_width)
        h = int(views[0].recommended_image_rect_height)
        return SystemInfo(
            recommended_size=(w, h),
            # filled in properly after session creation; sRGB preference
            # is applied against the real list then
            color_formats=(0x8C43, 0x8058),
            reference_spaces=(ReferenceSpace.STAGE, ReferenceSpace.LOCAL),
        )

    def create_session(self, space, swapchains) -> None:
        xr = self._xr
        glfw = self._glfw
        # hidden GL context for the XR GL binding (reference
        # implementation.py:983-1046 hidden-window pattern)
        if not glfw.init():
            raise RuntimeError("glfw.init failed")
        glfw.window_hint(glfw.VISIBLE, glfw.FALSE)
        glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 3)
        glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 3)
        glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_CORE_PROFILE)
        self._win = glfw.create_window(64, 64, "d2s-xr", None, None)
        glfw.make_context_current(self._win)

        # GL graphics requirements must be queried before session create
        xr.get_opengl_graphics_requirements_khr(self.instance, self.system_id)
        binding = xr.utils.gl.create_graphics_binding()  # GLX/WGL per host
        self.session = xr.create_session(self.instance, xr.SessionCreateInfo(
            system_id=self.system_id, next=binding))

        from desktop2stereo_tpu_torch.xr.session import ReferenceSpace

        ref_type = (xr.ReferenceSpaceType.STAGE
                    if space == ReferenceSpace.STAGE
                    else xr.ReferenceSpaceType.LOCAL)
        self.space = xr.create_reference_space(
            self.session, xr.ReferenceSpaceCreateInfo(reference_space_type=ref_type))

        fmts = xr.enumerate_swapchain_formats(self.session)
        from desktop2stereo_tpu_torch.xr.session import choose_color_format

        fmt = choose_color_format(list(fmts))
        self.swapchains = []
        for spec in swapchains:
            sc = xr.create_swapchain(self.session, xr.SwapchainCreateInfo(
                usage_flags=(xr.SwapchainUsageFlags.COLOR_ATTACHMENT_BIT
                             | xr.SwapchainUsageFlags.SAMPLED_BIT),
                format=fmt, sample_count=1,
                width=spec.width, height=spec.height,
                face_count=1, array_size=1, mip_count=1))
            images = xr.enumerate_swapchain_images(
                sc, xr.SwapchainImageOpenGLKHR)
            self.swapchains.append((sc, images, (spec.width, spec.height)))

        self._init_gl()
        self._create_action_set()
        # xr.begin_session is NOT called here: the spec requires waiting
        # for the runtime's SESSION_STATE_READY event first (reference
        # xr_session.py:117-226 does the same) — poll_phase_events begins
        # the session when that event arrives.

    def _init_gl(self) -> None:
        """Theater draw-list backend + per-(eye, image) FBO wrappers over
        the swapchain textures (with shared depth renderbuffers — the
        theater's room geometry needs z-testing, unlike the old bare
        screen quad)."""
        from OpenGL import GL

        from desktop2stereo_tpu_torch.xr.gl_theater import TheaterGL

        backend = TheaterGL()
        depth_rbs = {}
        for eye, (_sc, _images, (w, h)) in enumerate(self.swapchains):
            rb = GL.glGenRenderbuffers(1)
            GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, rb)
            GL.glRenderbufferStorage(GL.GL_RENDERBUFFER,
                                     GL.GL_DEPTH_COMPONENT24, w, h)
            depth_rbs[eye] = rb
        self._gl = {"backend": backend, "GL": GL, "fbos": {},
                    "depth_rbs": depth_rbs, "frame_uploaded_seq": -1}

    def _create_action_set(self) -> None:
        """Action set for the chord router (xr/controls.py): one action per
        role in xr/session.py's BINDING_TABLES, hand-scoped via subaction
        paths (the reference creates the same set per vendor table,
        reference xr_session.py:340-433).  Failure leaves the presenter in
        controller-less stereo-theater mode — pixels still reach the HMD."""
        xr = self._xr
        self._action_set = None
        self._actions_attached = False
        self._last_display_time = None
        try:
            self._path_l = xr.string_to_path(self.instance, "/user/hand/left")
            self._path_r = xr.string_to_path(self.instance, "/user/hand/right")
            aset = xr.create_action_set(self.instance, xr.ActionSetCreateInfo(
                action_set_name="d2s_controls",
                localized_action_set_name="desktop2stereo controls",
                priority=0))
            hands = [self._path_l, self._path_r]
            AT = xr.ActionType

            def act(name, atype, hand_scoped=True):
                return xr.create_action(aset, xr.ActionCreateInfo(
                    action_name=name, localized_action_name=name,
                    action_type=atype,
                    subaction_paths=hands if hand_scoped else []))

            self._acts = {
                "aim_pose": act("aim_pose", AT.POSE_INPUT),
                "grip_pose": act("grip_pose", AT.POSE_INPUT),
                "trigger": act("trigger", AT.FLOAT_INPUT),
                "squeeze": act("squeeze", AT.FLOAT_INPUT),
                "stick": act("stick", AT.VECTOR2F_INPUT),
                "stick_click": act("stick_click", AT.BOOLEAN_INPUT),
                "button_primary": act("button_a", AT.BOOLEAN_INPUT, False),
                "button_secondary": act("button_b", AT.BOOLEAN_INPUT, False),
                "button_x": act("button_x", AT.BOOLEAN_INPUT, False),
                "button_y": act("button_y", AT.BOOLEAN_INPUT, False),
                "menu": act("menu", AT.BOOLEAN_INPUT, False),
            }
            self._action_set = aset
            self._aim_spaces = {}
        except Exception:
            self._action_set = None

    def suggest_bindings(self, profile, bindings) -> bool:
        """Suggest the vendor table's bindings for our action set; a
        profile whose path does not resolve is skipped (SessionManager
        collects the accepted ones into bound_profiles)."""
        xr = self._xr
        try:
            prof_path = xr.string_to_path(self.instance, profile)
        except Exception:
            return False
        if getattr(self, "_action_set", None) is None:
            return True  # theater mode: profile accepted, no actions
        try:
            suggested = [
                xr.ActionSuggestedBinding(
                    action=self._acts[name],
                    binding=xr.string_to_path(self.instance, path))
                for name, path in bindings if name in self._acts
            ]
            xr.suggest_interaction_profile_bindings(
                self.instance, xr.InteractionProfileSuggestedBinding(
                    interaction_profile=prof_path,
                    suggested_bindings=suggested))
            return True
        except Exception:
            return False

    def _attach_actions(self) -> bool:
        if self._action_set is None or self.session is None:
            return False
        if self._actions_attached:
            return True
        xr = self._xr
        try:
            xr.attach_session_action_sets(
                self.session, xr.SessionActionSetsAttachInfo(
                    action_sets=[self._action_set]))
            # per-hand aim spaces for the laser → screen hit test
            for hand, path in (("l", self._path_l), ("r", self._path_r)):
                self._aim_spaces[hand] = xr.create_action_space(
                    self.session, xr.ActionSpaceCreateInfo(
                        action=self._acts["aim_pose"], subaction_path=path))
            self._actions_attached = True
            return True
        except Exception:
            self._action_set = None
            return False

    def sample_controllers(self):
        """One ControllerState snapshot for the chord router, or None when
        the action system is unavailable (theater mode)."""
        if not self._attach_actions():
            return None
        xr = self._xr
        try:
            from desktop2stereo_tpu_torch.xr.controls import ControllerState

            xr.sync_actions(self.session, xr.ActionsSyncInfo(
                active_action_sets=[xr.ActiveActionSet(
                    action_set=self._action_set,
                    subaction_path=xr.NULL_PATH)]))

            def fval(name, path):
                st = xr.get_action_state_float(
                    self.session, xr.ActionStateGetInfo(
                        action=self._acts[name], subaction_path=path))
                return float(st.current_state) if st.is_active else 0.0

            def bval(name, path=None):
                info = xr.ActionStateGetInfo(action=self._acts[name])
                if path is not None:
                    info.subaction_path = path
                st = xr.get_action_state_boolean(self.session, info)
                return bool(st.current_state) if st.is_active else False

            def v2val(path):
                st = xr.get_action_state_vector2f(
                    self.session, xr.ActionStateGetInfo(
                        action=self._acts["stick"], subaction_path=path))
                if st.is_active:
                    return (float(st.current_state.x),
                            float(st.current_state.y))
                return (0.0, 0.0)

            laser = {"l": False, "r": False}
            pose = getattr(self, "screen_pose", None)
            t = self._last_display_time
            self.last_aim = {}
            if pose is not None and t is not None:
                from desktop2stereo_tpu_torch.xr.laser import ray_screen_hit

                for hand, space in self._aim_spaces.items():
                    try:
                        loc = xr.locate_space(space, self.space, t)
                        flags = int(loc.location_flags)
                        if flags & 0x2:  # POSITION_VALID
                            o = loc.pose.orientation
                            p = loc.pose.position
                            origin = np.array([p.x, p.y, p.z], np.float64)
                            direction = _quat_forward(
                                (o.x, o.y, o.z, o.w))
                            # stashed for the presenter's beam/controller
                            # rendering (theater lasers)
                            self.last_aim[hand] = (origin, direction)
                            laser[hand] = ray_screen_hit(
                                origin, direction, pose) is not None
                    except Exception:
                        pass

            return ControllerState(
                grip_l=fval("squeeze", self._path_l) > 0.55,
                grip_r=fval("squeeze", self._path_r) > 0.55,
                stick_l=v2val(self._path_l),
                stick_r=v2val(self._path_r),
                stick_btn_l=bval("stick_click", self._path_l),
                stick_btn_r=bval("stick_click", self._path_r),
                btn_a=bval("button_primary"),
                btn_b=bval("button_secondary"),
                btn_x=bval("button_x"),
                btn_y=bval("button_y"),
                btn_menu=bval("menu"),
                trigger_l=fval("trigger", self._path_l),
                trigger_r=fval("trigger", self._path_r),
                laser_l_on_screen=laser["l"],
                laser_r_on_screen=laser["r"],
            )
        except Exception:
            return None

    def destroy_session(self) -> None:
        xr = self._xr
        for sc, _imgs, _size in self.swapchains:
            try:
                xr.destroy_swapchain(sc)
            except Exception:
                pass
        self.swapchains = []
        if self.session is not None:
            if self._running:
                try:
                    xr.end_session(self.session)
                except Exception:
                    pass
                self._running = False
            try:
                xr.destroy_session(self.session)
            except Exception:
                pass
            self.session = None

    # ---- frame-loop interface ---------------------------------------------

    def poll_phase_events(self):
        import ctypes

        from desktop2stereo_tpu_torch.xr.session import SessionPhase

        xr = self._xr
        if self._phase_map is None:
            self._phase_map = {
                xr.SessionState.READY: SessionPhase.READY,
                xr.SessionState.SYNCHRONIZED: SessionPhase.SYNCHRONIZED,
                xr.SessionState.VISIBLE: SessionPhase.VISIBLE,
                xr.SessionState.FOCUSED: SessionPhase.FOCUSED,
                xr.SessionState.STOPPING: SessionPhase.STOPPING,
                xr.SessionState.EXITING: SessionPhase.EXITING,
            }
        phases = []
        while True:
            try:
                buf = xr.poll_event(self.instance)
            except xr.EventUnavailable:
                break
            # poll_event returns a generic EventDataBuffer whose payload
            # must be reinterpreted by its structure type tag
            event = None
            if isinstance(buf, xr.EventDataSessionStateChanged):
                event = buf  # a runtime/test double may hand typed events
            elif (xr.StructureType(buf.type)
                  == xr.StructureType.EVENT_DATA_SESSION_STATE_CHANGED):
                event = ctypes.cast(
                    ctypes.byref(buf),
                    ctypes.POINTER(xr.EventDataSessionStateChanged)).contents
            if event is None:
                continue
            phase = self._phase_map.get(xr.SessionState(event.state))
            if phase is not None:
                phases.append(phase)
                # the spec's session-begin handshake: READY → begin_session,
                # STOPPING → end_session (reference xr_session.py:117-226)
                if phase is SessionPhase.READY and not self._running:
                    xr.begin_session(self.session, xr.SessionBeginInfo(
                        primary_view_configuration_type=(
                            xr.ViewConfigurationType.PRIMARY_STEREO)))
                    self._running = True
                elif phase is SessionPhase.STOPPING and self._running:
                    try:
                        xr.end_session(self.session)
                    finally:
                        self._running = False
        return phases

    @property
    def running(self) -> bool:
        """True between begin_session and end_session — the only window in
        which wait_frame/begin_frame/end_frame are legal to call."""
        return self._running

    def wait_frame(self):
        xr = self._xr
        state = xr.wait_frame(self.session, xr.FrameWaitInfo())
        # stashed for sample_controllers' aim-space location (laser hits)
        self._last_display_time = state.predicted_display_time
        return state.predicted_display_time, bool(state.should_render)

    def begin_frame(self) -> None:
        self._xr.begin_frame(self.session, self._xr.FrameBeginInfo())

    def locate_views(self, display_time):
        xr = self._xr
        _state, views = xr.locate_views(self.session, xr.ViewLocateInfo(
            view_configuration_type=xr.ViewConfigurationType.PRIMARY_STEREO,
            display_time=display_time, space=self.space))
        self._views = views
        return [
            XrView(
                orientation_xyzw=(v.pose.orientation.x, v.pose.orientation.y,
                                  v.pose.orientation.z, v.pose.orientation.w),
                position=(v.pose.position.x, v.pose.position.y,
                          v.pose.position.z),
                fov=(v.fov.angle_left, v.fov.angle_right,
                     v.fov.angle_up, v.fov.angle_down),
            )
            for v in views
        ]

    def render_eye(self, eye, rgb, depth, view, *, eye_offset, strength,
                   convergence, roll) -> None:
        xr = self._xr
        sc, images, (w, h) = self.swapchains[eye]
        idx = xr.acquire_swapchain_image(sc, xr.SwapchainImageAcquireInfo())
        xr.wait_swapchain_image(sc, xr.SwapchainImageWaitInfo(
            timeout=xr.INFINITE_DURATION))
        try:
            gl = self._gl
            GL = gl["GL"]
            backend = gl["backend"]
            # frame textures are shared by both eyes: upload once per frame
            if eye == 0 or gl["frame_uploaded_seq"] != id(rgb):
                backend.set_frame(rgb, depth)
                gl["frame_uploaded_seq"] = id(rgb)
            tex_id = images[idx].image
            fbo = gl["fbos"].get((eye, idx))
            if fbo is None:
                fbo = GL.glGenFramebuffers(1)
                GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, fbo)
                GL.glFramebufferTexture2D(
                    GL.GL_FRAMEBUFFER, GL.GL_COLOR_ATTACHMENT0,
                    GL.GL_TEXTURE_2D, tex_id, 0)
                GL.glFramebufferRenderbuffer(
                    GL.GL_FRAMEBUFFER, GL.GL_DEPTH_ATTACHMENT,
                    GL.GL_RENDERBUFFER, gl["depth_rbs"][eye])
                gl["fbos"][(eye, idx)] = fbo
            GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, fbo)

            dibr = {"eye_offset": eye_offset, "strength": strength,
                    "convergence": convergence, "roll": roll,
                    "corner_radius": self.corner_radius}
            th = self.theater
            if th is not None:
                from desktop2stereo_tpu_torch.xr.raster import (
                    proj_from_fov, view_from_pose)

                if abs(th.screen.width / max(th.screen.height, 1e-6)
                       - rgb.shape[1] / rgb.shape[0]) > 1e-3:
                    th.set_aspect(rgb.shape[1] / rgb.shape[0])
                clear, items = th.frame_items(rgb, gpu=True, dibr=dibr)
                vmat = view_from_pose(view.position, view.orientation)
                pmat = proj_from_fov(view.fov)
                backend.render((0, 0, w, h), clear, items, vmat, pmat)
            else:
                ident = np.eye(4, np.float32)
                backend.render((0, 0, w, h), (0.0, 0.0, 0.0),
                               [_fullscreen_screen_item(dibr)], ident, ident)
            GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, 0)
        finally:
            xr.release_swapchain_image(sc, xr.SwapchainImageReleaseInfo())

    def end_frame(self, display_time, rendered: bool) -> None:
        xr = self._xr
        layers = []
        if rendered and getattr(self, "_views", None) is not None:
            proj_views = []
            for eye, view in enumerate(self._views):
                sc, _images, (w, h) = self.swapchains[eye]
                proj_views.append(xr.CompositionLayerProjectionView(
                    pose=view.pose, fov=view.fov,
                    sub_image=xr.SwapchainSubImage(
                        swapchain=sc,
                        image_rect=xr.Rect2Di(
                            offset=xr.Offset2Di(0, 0),
                            extent=xr.Extent2Di(w, h)))))
            layers.append(xr.CompositionLayerProjection(
                space=self.space, views=proj_views))
        xr.end_frame(self.session, xr.FrameEndInfo(
            display_time=display_time,
            environment_blend_mode=xr.EnvironmentBlendMode.OPAQUE,
            layers=layers))


def theater_enabled(args, kind: str) -> bool:
    """--theater auto: the GL/XR presenters default to the virtual theater
    (screen-in-a-room, VERDICT's reference parity bar); the flat cv/png
    presenters default to plain SBS output like the reference's 2D modes."""
    mode = getattr(args, "theater", "auto")
    if mode == "auto":
        return kind in ("glfw", "openxr")
    return mode == "on"


def build_theater(args):
    from desktop2stereo_tpu_torch.xr.theater import Theater

    th = Theater.from_env_dir(getattr(args, "env", None),
                              lang=getattr(args, "lang", "EN"))
    vendor = getattr(args, "vendor", None)
    if vendor:
        th.vendor = vendor
    return th


def make_presenter(kind: str, args, input_sink=None) -> object:
    if kind == "auto":
        for cand in ("glfw", "cv", "png"):
            try:
                return make_presenter(cand, args, input_sink)
            except Exception:
                continue
        raise SystemExit("no presenter available")
    theater = build_theater(args) if theater_enabled(args, kind) else None
    if kind == "openxr":
        try:
            return OpenXRPresenter(args.ipd, args.depth_strength,
                                   args.convergence,
                                   corner_radius=args.corner_radius,
                                   theater=theater, input_sink=input_sink)
        except RuntimeError as e:
            raise SystemExit(f"openxr presenter unavailable: {e}")
    if kind == "glfw":
        return GlfwPresenter(args.ipd, args.depth_strength, args.convergence,
                             roll=args.roll, corner_radius=args.corner_radius,
                             theater=theater)
    if kind == "cv":
        return CvPresenter()
    if kind == "png":
        return PngPresenter(args.out)
    raise SystemExit(f"unknown presenter {kind!r}")


class SoftTheaterCompositor:
    """CPU-rasterized theater for the flat presenters (--theater on with
    cv/png): per-eye DIBR warp of the frame on `device`, rounded to uint8
    there, then the full theater rendered by the host rasterizer — the
    headless twin of the GL path, and what the offline tests pin.  Each
    eye's texture is downloaded inside `Theater.frame_items`, after its
    light terms are reduced on the device."""

    def __init__(self, theater, ipd: float, depth_strength: float,
                 convergence: float, eye_size: Tuple[int, int] = (480, 270),
                 mode: str = "Full-SBS", roll: float = 0.0, device="cuda"):
        self.theater = theater
        self.ipd = ipd
        self.strength = depth_strength
        self.convergence = convergence
        self.eye_size = eye_size
        self.mode = mode
        self.roll = roll
        self.device = torch.device(device)

    def compose(self, rgb, depth) -> np.ndarray:
        from desktop2stereo_tpu_torch.xr.raster import (
            render_items, symmetric_proj, view_translate)

        th = self.theater
        if abs(th.screen.width / max(th.screen.height, 1e-6)
               - rgb.shape[1] / rgb.shape[0]) > 1e-3:
            th.set_aspect(rgb.shape[1] / rgb.shape[0])
        w, h = self.eye_size
        if self.mode == "Half-SBS":
            w = w // 2
        proj = symmetric_proj(_THEATER_FOV_DEG, w / max(h, 1))
        rgb_t = to_device(rgb, self.device)
        dep = None
        if depth is not None:
            dep = _resize_bilinear(to_device(depth, self.device).to(torch.float32),
                                   rgb_t.shape[0], rgb_t.shape[1])
        eyes = []
        for eye in (-1, +1):
            if dep is not None:
                tex = round_u8(warp_eye(
                    rgb_t, dep, eye * self.ipd / 2, self.strength,
                    self.convergence, roll=self.roll))
            else:
                tex = rgb_t
            clear, items = th.frame_items(tex)
            view = view_translate(
                (eye * _CAMERA_HALF_IPD_M, th.origin_y, 0.0))
            eyes.append(render_items(w, h, clear, items, view, proj))
        return np.concatenate(eyes, axis=1)


# --------------------------------------------------------------------------
# Client loop
# --------------------------------------------------------------------------

def adopt_server_meta(args, meta: dict) -> None:
    """Fill stereo flags the user left unset from the server's advertised
    session config — the server's settings.yaml then drives the remote
    render exactly as the reference's file drives its local viewer
    (reference utils.py:851-852).  Explicit flags win."""
    for flag, key in (("ipd", "ipd"), ("depth_strength", "depth_strength"),
                      ("convergence", "convergence")):
        if getattr(args, flag) is None:
            v = meta.get(key)
            setattr(args, flag, float(v) if v is not None else
                    {"ipd": 0.064, "depth_strength": 2.0,
                     "convergence": 0.01}[flag])


class SelfTestSource:
    """Standalone smoke source: white 1280×720 RGB + zero depth, no server.

    The reference ships `python xrviewer.py` — a harness that pre-seeds
    the viewer's frame queue with a white 1280×720 frame and zero depth so
    presentation, controllers, and keyboard can be exercised without the
    capture/depth pipeline (reference xrviewer.py:13-14,
    xr_viewer/implementation.py:2321-2351).  This is that harness for the
    workstation client: `--test` swaps it in for FrameNetClient, so every
    presenter (openxr/glfw/cv/png) can be smoke-driven offline.
    Zero depth ⇒ zero parallax ⇒ both eyes must be the unwarped source —
    a self-evident visual pass/fail, same as the reference's."""

    def __init__(self, size=(1280, 720), fps: float = 60.0):
        w, h = size
        self._rgb = np.full((h, w, 3), 255, np.uint8)
        self._depth = np.zeros((h, w), np.float32)
        self._seq = 0
        self._interval = 1.0 / fps if fps > 0 else 0.0
        self._next = time.perf_counter()

    def meta(self) -> dict:
        return {}

    def poll(self, timeout: float = 1.0):
        from desktop2stereo_tpu_torch.xr.frame_server import FramePacket

        now = time.perf_counter()
        if now < self._next:
            time.sleep(self._next - now)
        self._next = time.perf_counter() + self._interval
        self._seq += 1
        return FramePacket(self._rgb, self._depth, self._seq, time.time())

    def close(self) -> None:
        pass


def run_client(args) -> int:
    # the warp's device first: without a card this exits 2 naming CUDA
    # before any connection is made
    device, _ = device_policy(getattr(args, "device", "cuda"), True)
    if getattr(args, "test", False):
        client = SelfTestSource()
    else:
        client = FrameNetClient(host=args.host, port=args.port,
                                encoding=args.encoding)
    try:
        meta = client.meta()
    except Exception:
        meta = {}
    adopt_server_meta(args, meta)
    if args.verbose and meta:
        print(f"[xr-client] server session config: {meta}")
    # laser → OS-input events ride the same connection back to the host
    # (reference input.py:121-390's loop; inert in --test mode)
    input_sink = getattr(client, "send_input", None)
    if getattr(args, "no_input", False):
        input_sink = None
    presenter = make_presenter(args.present, args, input_sink)
    # CPU-rasterized theater for flat presenters (--theater on): the room
    # around the warped screen, the GL paths' headless twin
    soft_theater = None
    if (not getattr(presenter, "gpu_warp", False)
            and theater_enabled(args, args.present)):
        soft_theater = SoftTheaterCompositor(
            build_theater(args), args.ipd, args.depth_strength,
            args.convergence, eye_size=tuple(args.theater_size),
            mode=args.mode, roll=args.roll, device=device)
        for key in ("fps_overlay", "glow", "keyboard", "help_panel"):
            if getattr(args, f"show_{key}", False):
                soft_theater.theater.ui[key] = True
    # pose-noise smoothing for the latency OSD (reference OneEuro usage,
    # reference xr_viewer/input.py:474-530)
    lat_filter = OneEuroFilter(min_cutoff=0.5, beta=0.05)
    # virtual-screen policy lives server/client-agnostic in xr/geometry.py;
    # instantiating it here keeps the presets/pose math on the client path
    screen = ScreenPose()
    _ = screen.model_matrix()

    frames = 0
    t_last = time.perf_counter()
    try:
        while args.frames is None or frames < args.frames:
            pkt = client.poll(timeout=args.poll_timeout)
            if pkt is None:
                if args.frames is not None and args.idle_exit:
                    break
                continue
            now = time.perf_counter()
            dt = max(now - t_last, 1e-6)
            t_last = now
            latency_ms = lat_filter(dt * 1000.0, dt)
            if getattr(presenter, "gpu_warp", False):
                alive = presenter.push_packet(pkt.rgb, pkt.depth)
            elif soft_theater is not None:
                soft_theater.theater.set_stats(
                    1000.0 / max(latency_ms, 1e-3), latency_ms=latency_ms)
                alive = presenter.push(
                    soft_theater.compose(pkt.rgb, pkt.depth))
            else:
                sbs = render_stereo(pkt.rgb, pkt.depth, args.ipd,
                                    args.depth_strength, args.convergence,
                                    mode=args.mode, roll=args.roll,
                                    device=device)
                alive = presenter.push(sbs.cpu().numpy())
            frames += 1
            if args.verbose and frames % 30 == 0:
                print(f"[xr-client] seq {pkt.seq}, {1000.0/latency_ms:.1f} fps")
            if not alive:
                break
    finally:
        presenter.close()
        client.close()
    print(f"[xr-client] rendered {frames} frames")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="d2s-xr-client",
        description="workstation stereo/XR client for the d2s xr sink")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1123)
    p.add_argument("--encoding", default="raw", choices=["raw", "jpeg"])
    p.add_argument("--present", default="auto",
                   choices=["auto", "openxr", "glfw", "cv", "png"])
    p.add_argument("--roll", type=float, default=0.0,
                   help="screen roll in radians (parallax direction; the "
                        "openxr presenter derives it from head pose)")
    p.add_argument("--corner-radius", type=float, default=0.0,
                   help="rounded-corner SDF radius in UV units (GPU "
                        "presenters)")
    p.add_argument("--theater", default="auto", choices=["auto", "on", "off"],
                   help="virtual theater (environment + screen-in-a-room + "
                        "effects/overlays): auto = on for glfw/openxr, off "
                        "for cv/png")
    p.add_argument("--env", default=None,
                   help="environment folder (environment.glb + profile.json "
                        "+ optional panorama, reference environments/ "
                        "schema); default: generated dark room")
    p.add_argument("--lang", default="EN", choices=["EN", "CN"],
                   help="overlay/help-panel language")
    p.add_argument("--vendor", default=None,
                   help="controller model style: generic/quest/vive/index/"
                        "pico/yvr/hp")
    p.add_argument("--theater-size", type=int, nargs=2, default=(480, 270),
                   metavar=("W", "H"),
                   help="per-eye render size for the CPU theater (cv/png)")
    p.add_argument("--no-input", action="store_true",
                   help="don't send laser/keyboard OS-input events back to "
                        "the capture host (view-only session)")
    for key in ("fps-overlay", "glow", "keyboard", "help-panel"):
        p.add_argument(f"--show-{key}", action="store_true",
                       dest=f"show_{key.replace('-', '_')}",
                       help=f"start with the {key.replace('-', ' ')} visible "
                            "(CPU theater)")
    p.add_argument("--mode", default="Full-SBS",
                   choices=["Full-SBS", "Half-SBS"])
    p.add_argument("--ipd", type=float, default=None,
                   help="default: the server's settings value, else 0.064")
    p.add_argument("--depth-strength", type=float, default=None,
                   help="default: the server's settings value, else 2.0")
    p.add_argument("--convergence", type=float, default=None,
                   help="default: the server's settings value, else 0.01")
    p.add_argument("--test", action="store_true",
                   help="standalone smoke mode: white 1280x720 + zero depth, "
                        "no server (the reference's `python xrviewer.py` "
                        "harness)")
    p.add_argument("--frames", type=int, help="stop after N frames")
    p.add_argument("--out", default="xr_frames", help="png presenter dir")
    p.add_argument("--poll-timeout", type=float, default=1.0)
    p.add_argument("--idle-exit", action="store_true",
                   help="exit when a bounded run sees no new frames")
    p.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="where the flat and theater paths warp: 'cuda' "
                        "(default; 'auto' is an alias): CUDA device 0, no "
                        "CPU fallback; 'cpu': the plain-PyTorch versions")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    return run_client(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
