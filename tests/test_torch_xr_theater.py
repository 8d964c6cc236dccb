"""The port's XR client host modules against the JAX package on the CPU.

Geometry, filters, the rasterizer's pixels, environment profiles, GLB
parsing, controller meshes, the keyboard layout, overlay bitmaps, laser
hits, persisted state and the theater's draw lists: the same inputs through
`desktop2stereo_tpu.xr.*` and `desktop2stereo_tpu_torch.xr.*`, exactly
equal.  The frame-derived effects (border glow, ambient spill) are torch
ops in the port and are held to JAX's on a `jnp` array at atol 1e-5; the
CPU theater compositor's uint8 output is held to JAX's within 1 LSB.
Overlay text is drawn by PIL in both packages on this host, so the bitmaps
compare byte for byte.
"""

import json
import math
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_xr_theater import _glb_colored_wall
from torch_threads import one_torch_thread  # noqa: F401
from torch_xr_common import assert_same, client, u8_share, xr

PKGS = ("jax", "port")


def both(name):
    return xr("jax", name), xr("port", name)


def bright_profile(env):
    return env.EnvironmentProfile(lighting=env.Lighting(
        exposure=1.2, ambient_color=(0.10, 0.10, 0.12),
        head_light_color=(0.5, 0.5, 0.55)),
        fill_lights=(env.FillLight(position=(0.0, 2.6, -2.0),
                                   color=(0.9, 0.8, 0.6), range=7.0),))


def test_port_has_every_client_module_of_the_jax_package():
    for name in ("geometry", "filters", "effects", "raster", "glb", "controller_models",
                 "environment", "keyboard", "overlay", "laser", "persist", "theater",
                 "input_map", "input_router", "controls", "session", "gl_theater",
                 "headless_gl"):
        j, t = both(name)
        public = {n for n in dir(j) if not n.startswith("_") and callable(getattr(j, n))
                  and getattr(getattr(j, n), "__module__", "") == j.__name__}
        missing = sorted(n for n in public if not hasattr(t, n))
        assert not missing, (name, missing)
    import desktop2stereo_tpu.xr as J
    import desktop2stereo_tpu_torch.xr as T
    assert T.__all__ == J.__all__


GL_SCRIPT = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from desktop2stereo_tpu_torch.xr.headless_gl import create_headless_context, read_pixels
W, H = 240, 136
try:
    ctx = create_headless_context(W, H)
except RuntimeError as e:
    print("GL unavailable:", e)
    sys.exit(0)
from desktop2stereo_tpu.xr import environment as JE, raster as JR, theater as JT
from desktop2stereo_tpu.xr import gl_theater as JG
from desktop2stereo_tpu_torch.xr import gl_theater as TG
assert "torch" not in sys.modules
th = JT.Theater(profile=JE.EnvironmentProfile(lighting=JE.Lighting(exposure=1.2)))
th.ui.update(glow=True, fps_overlay=True, keyboard=True)
rgb = np.zeros((90, 160, 3), np.uint8)
rgb[:, :, 0] = 200
rgb[30:60, 53:107] = (30, 220, 40)
depth = np.zeros((90, 160), np.float32)
depth[30:60, 50:110] = 1.0
imgs = {}
for name, mod in (("jax", JG), ("port", TG)):
    gl, out = mod.TheaterGL(), []
    for eye in (-1, 1):
        gl.set_frame(rgb, depth)
        dibr = {"eye_offset": eye * 0.032, "strength": 2.0, "convergence": 0.0,
                "roll": 0.0, "corner_radius": 0.02}
        clear, items = th.frame_items(rgb, gpu=True, dibr=dibr, now=100.0)
        gl.render((0, 0, W, H), clear, items, JR.view_translate((eye * 0.032, th.origin_y, 0.0)),
                  JR.symmetric_proj(75.0, W / H))
        out.append(read_pixels(W, H))
    imgs[name] = out
assert all(np.array_equal(a, b) for a, b in zip(imgs["jax"], imgs["port"]))
assert not np.array_equal(imgs["port"][0], imgs["port"][1])
assert TG.DIBR_FRAG == JG.DIBR_FRAG
ctx.destroy()
print("ok")
"""


def test_gl_theater_renders_like_jax_in_a_clean_process():
    """The port's TheaterGL (every program compiled, the DIBR screen shader
    at both eyes) against JAX's on one headless Mesa context, pixel for
    pixel.  Mesa's llvmpipe cannot share a process with torch's native
    runtime (tests/test_gl_theater.py), so this runs in a fresh interpreter
    that never imports torch."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", GL_SCRIPT, root], capture_output=True,
                       text=True, timeout=300, cwd=root,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if r.returncode == 0 and r.stdout.startswith("GL unavailable"):
        pytest.skip(r.stdout.strip())  # a host without PyOpenGL's EGL or Mesa
    assert r.returncode == 0 and r.stdout.strip().splitlines()[-1] == "ok", (
        r.stdout + r.stderr)


# ---- geometry and filters ----------------------------------------------------------


def test_geometry_matches_jax():
    out = {}
    for pkg in PKGS:
        g = xr(pkg, "geometry")
        pose = g.ScreenPose(width=4.0, height=2.25, distance=3.0, pan_x=0.5, pan_y=0.2,
                            yaw=0.7, pitch=-0.3, roll=0.2)
        grab = g.GrabState()
        grab.begin(pose.with_preset(1), (0.0, 0.1, 0.0))
        out[pkg] = [pose.rotation(), pose.model_matrix(), pose.model_matrix(0.012),
                    pose.flat_mesh(), pose.curved_mesh(), pose.curved_mesh(8, "vertical"),
                    pose.with_aspect(21 / 9), [pose.with_preset(i) for i in range(6)],
                    grab.update((0.3, -0.1, 0.5)), g.SCREEN_PRESETS, g.CURVED_HALF_ANGLE_RAD]
        fs = xr(pkg, "frame_server").FrameServer()
        out[pkg].append(fs.geometry_for(4 / 3))
    assert_same(out["port"], out["jax"])


def test_filters_match_jax():
    rng = np.random.default_rng(0)
    xs = 1.0 + rng.normal(0, 0.05, 120)
    pts = rng.normal(0, 1, (40, 3))
    out = {}
    for pkg in PKGS:
        f = xr(pkg, "filters")
        one = f.OneEuroFilter(min_cutoff=1.0, beta=0.02)
        seq = [one(float(x), 1 / 90) for x in xs]
        one.reset()
        seq += [one(i * 0.1, 1 / 90) for i in range(30)]
        three = f.OneEuroFilter3D()
        seq3 = [three(tuple(p), 1 / 72) for p in pts]
        q0 = np.array([0, 0, 0, 1.0])
        q1 = np.array([0, math.sin(math.pi / 4), 0, math.cos(math.pi / 4)])
        sl = [f.slerp(q0, q1, t) for t in (0.0, 0.25, 0.5, 1.0)] + [f.slerp(q0, q0, 0.5)]
        out[pkg] = [seq, seq3, sl]
    assert_same(out["port"], out["jax"])


# ---- effects --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 96, 3), (9, 5, 3), (270, 480, 3)])
def test_frame_effects_on_a_tensor_match_jax_on_jnp(shape):
    rng = np.random.default_rng(sum(shape))
    rgb = (rng.random(shape) * 255).astype(np.float32)
    je, te = both("effects")
    t = torch.from_numpy(rgb)
    for kw in ({}, {"band_frac": 0.2, "reduction": 0.9}):
        got = te.border_glow_color(t, **kw)
        assert isinstance(got, torch.Tensor) and got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(je.border_glow_color(
            jnp.asarray(rgb), **kw)), atol=1e-5, rtol=0)
    for inten in (3.5, 1.0):
        s, tint = te.ambient_spill(t, inten)
        js, jt = je.ambient_spill(jnp.asarray(rgb), inten)
        assert s.shape == () and tint.shape == (3,)
        np.testing.assert_allclose(float(s), float(js), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tint.numpy(), np.asarray(jt), atol=1e-5, rtol=0)


def test_effects_host_math_matches_jax():
    out = {}
    for pkg in PKGS:
        e, g = xr(pkg, "effects"), xr(pkg, "geometry")
        pose = g.ScreenPose(width=3.0, height=1.7, yaw=0.2, pan_x=0.1)
        cyc, pt = e.BackgroundCycler(), e.PassthroughState()
        out[pkg] = [e.glow_band_mesh(pose), e.glow_band_mesh(pose, curved=True),
                    e.glow_band_mesh(pose, band=0.3, curved=True, curve_axis="vertical",
                                     segments=12),
                    [e.frost_lod(s) for s in (-1.0, 0.0, 0.3, 1.0, 2.0)],
                    [cyc.advance() for _ in range(8)], pt.toggle(),
                    pt.clear_color((0.1, 0.1, 0.1)), e.EffectsConfig(), e.BACKGROUND_COLORS]
    assert_same(out["port"], out["jax"])


# ---- rasterizer --------------------------------------------------------------------


def _raster_scene(r, rng):
    tri = np.array([[-0.5, -0.5, -2.0], [0.5, -0.5, -2.0], [0.0, 0.6, -2.5]], np.float32)
    cols = rng.random((3, 4)).astype(np.float32)
    cols[:, 3] = 1.0
    quad = np.array([[-1, -1, -3], [1, -1, -3], [-1, 1, -3], [1, 1, -3]], np.float32)
    uvs = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)
    tex = (rng.random((17, 23, 3)) * 255).astype(np.uint8)
    clip = np.array([[-0.3, 0.0, 0.5], [0.3, 0.0, -2.0], [0.0, 0.4, -2.0]], np.float32)
    return [r.DrawItem(kind="env", verts=quad, uvs=uvs, mode="strip", texture=tex),
            r.DrawItem(kind="env", verts=tri, colors=cols),
            r.DrawItem(kind="glow", verts=tri + [0.2, 0.0, 0.3], colors=cols,
                       blend="additive", depth_write=False),
            r.DrawItem(kind="env", verts=clip, colors=cols)]


def test_raster_pixels_match_jax():
    out = {}
    for pkg in PKGS:
        r = xr(pkg, "raster")
        rng = np.random.default_rng(3)
        items = _raster_scene(r, rng)
        view = r.view_from_pose((0.1, 0.2, 0.3), (0.0, 0.1, 0.0, 0.995))
        proj = r.proj_from_fov((-0.8, 0.7, 0.6, -0.65))
        out[pkg] = [r.render_items(96, 54, (0.1, 0.2, 0.3), items, view, proj),
                    r.render_items(64, 36, (0.0, 0.0, 0.0), items, r.view_translate(
                        (0.032, 0.0, 0.0)), r.symmetric_proj(75.0, 64 / 36)),
                    r.quat_matrix((0.1, 0.2, 0.3, 0.9)), proj, view]
    assert_same(out["port"], out["jax"])


# ---- GLB, environments, controllers -----------------------------------------------


def _glb_two_lights():
    """The JAX suite's green wall under a transformed node, with a point
    light and a spot light on child nodes."""
    data = _glb_colored_wall()
    jlen = int.from_bytes(data[12:16], "little")
    doc = json.loads(data[20:20 + jlen])
    doc["extensions"]["KHR_lights_punctual"]["lights"] += [
        {"type": "point", "color": [1, 0.5, 0.2], "intensity": 3.0},
        {"type": "spot", "intensity": 1.5}]
    doc["nodes"] = [{"mesh": 0, "name": "wall", "translation": [0, 0.5, 0],
                     "rotation": [0, 0.2, 0, 0.98], "children": [1, 2]},
                    {"extensions": {"KHR_lights_punctual": {"light": 1}},
                     "translation": [1, 2, -1]},
                    {"extensions": {"KHR_lights_punctual": {"light": 2}}}]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    rest = data[20 + jlen:]  # the BIN chunk, header included
    return (struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + len(rest))
            + struct.pack("<II", len(js), 0x4E4F534A) + js + rest)


def test_glb_parsing_matches_jax():
    blobs = [_glb_colored_wall(), _glb_two_lights()]
    out = {}
    for pkg in PKGS:
        glb = xr(pkg, "glb")
        scenes = [glb.load_glb(b) for b in blobs]
        errors = []
        for bad in (b"\x00" * 32, blobs[0][:40]):
            with pytest.raises(ValueError) as e:
                glb.load_glb(bad)
            errors.append(str(e.value))
        out[pkg] = [scenes, [s.bounds for s in scenes], errors]
    assert_same(out["port"], out["jax"])


def test_environment_profiles_match_jax(tmp_path):
    room = tmp_path / "rooms" / "greenroom"
    room.mkdir(parents=True)
    (room / "environment.glb").write_bytes(_glb_colored_wall())
    (room / "profile.json").write_text(json.dumps({
        "display_name": {"EN": "Green room", "CN": "绿房间"},
        "position": [1, 2, 3], "rotation_deg": [10, 0, 0], "khr_light_scale": 2.0,
        "ambient_color": [0.1, 0.2, 0.3],
        "fallback_lights": [{"position": [0, 2, -1], "color": [1, 1, 1], "range": 4.0}],
        "screen": {"screen_width": 5.0, "screen_position": [0, 1.5, -6], "curved": True},
        "view_pose": {"x": 0, "y": 1.6, "z": -2, "angle": 15},
        "lighting_presets": [{"name": "dim", "exposure": 0.5}]}))
    (room / "panorama.jpg").write_bytes(b"")
    bad = tmp_path / "rooms" / "bad"
    bad.mkdir()
    (bad / "profile.json").write_text("{not json")
    specs = [{}, {"type": "panorama"}, {"curve_axis": "vertical"},
             {"screen": {"curve_axis": "none", "allow_curve": False}}]
    out = {}
    for pkg in PKGS:
        env = xr(pkg, "environment")
        out[pkg] = [[env.parse_profile(s) for s in specs],
                    [env.curve_mode_from_json(s) for s in specs],
                    env.load_profile(str(room)), env.load_profile(str(bad)),
                    env.find_panorama_image(str(room)),
                    env.discover_environments(str(tmp_path / "rooms")),
                    env.default_room(), env.default_room(6.0, 2.8, 7.0),
                    env.panorama_sphere(), env.panorama_sphere(12, 6),
                    env.dark_room_profile()]
    assert_same(out["port"], out["jax"])


def test_controller_meshes_match_jax():
    out = {}
    for pkg in PKGS:
        cm = xr(pkg, "controller_models")
        vendors = ["generic", "quest", "vive", "index", "pico", "yvr", "hp", "unknown"]
        out[pkg] = [[cm.controller_mesh(v, h) for v in vendors for h in ("left", "right")],
                    [cm.next_vendor(v) for v in vendors]]
    assert_same(out["port"], out["jax"])


# ---- keyboard, overlay, laser, persist ------------------------------------------------


def test_keyboard_layout_and_state_match_jax():
    out = {}
    for pkg in PKGS:
        kb = xr(pkg, "keyboard")
        keys = kb.build_layout()
        st = kb.KeyboardState()
        by = {k.label: k for k in keys}
        presses = [st.press(by[n]) for n in ("Shift", "A", "Caps", "B", "Ctrl", "C", "1", "Alt", "Win", "F5")]
        rng = np.random.default_rng(1)
        hits = [kb.hit_key(keys, float(x), float(y)) for x, y in rng.uniform(-0.35, 0.35, (64, 2))]
        out[pkg] = [keys, kb.build_layout(0.4, 0.15), presses, [st.label_for(k) for k in keys],
                    hits, st, kb.VK]
    assert_same(out["port"], out["jax"])


def test_overlay_bitmaps_match_jax():
    out = {}
    for pkg in PKGS:
        ov, kb = xr(pkg, "overlay"), xr(pkg, "keyboard")
        keys = kb.build_layout()
        st = kb.KeyboardState()
        st.press({k.label: k for k in keys}["Shift"])
        th = ov.OverlayThrottle(interval=0.5)
        out[pkg] = [ov.render_text_panel(["hello", "world"], width=300, highlight=1),
                    ov.fps_panel(59.9, 48.2, 14.1, model="DA-V2-L", depth_strength=2.0),
                    ov.depth_osd(2.0), ov.depth_osd(2.0, lang="CN"),
                    ov.preset_osd("Cinema", 0, 4), ov.seat_osd("Center", 0, 3, lang="CN"),
                    ov.crop_osd("auto", (0.02, 0.1, 0.98, 0.9), paused=True),
                    ov.help_rows("EN"), ov.help_rows("CN"),
                    ov.render_help_panel("EN"), ov.render_help_panel("CN", width=600),
                    ov.render_keyboard_texture(keys, hover=10, pressed=3),
                    ov.render_keyboard_texture(keys, state=st, width=640, height=192),
                    [th.maybe(ov.depth_osd, v, now=t) for v, t in ((1.0, 0.0), (2.0, 0.2),
                                                                  (3.0, 0.6))]]
    assert_same(out["port"], out["jax"])


def test_laser_hits_match_jax():
    rng = np.random.default_rng(2)
    rays = [(np.array([0.0, 1.4, 0.0]) + rng.normal(0, 0.2, 3),
             np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.3, 3)) for _ in range(24)]
    rays.append((np.array([0.0, 1.4, 0.0]), np.array([0.0, 0.0, 1.0])))  # facing away
    out = {}
    for pkg in PKGS:
        la, g = xr(pkg, "laser"), xr(pkg, "geometry")
        pose = g.ScreenPose(seat_height=1.4, yaw=0.1)
        panel = la.PlaneSpec(pan_y=1.0, distance=0.8, yaw=0.1, pitch=-0.5)
        cal = la.HandCalibration().nudge(0.05, -0.02)
        out[pkg] = [[(la.ray_screen_hit(o, d, pose), la.ray_screen_hit(o, d, pose, curved=True),
                      la.ray_plane_uv(o, d, pose), la.ray_panel_hit(o, d, panel),
                      cal.apply(d)) for o, d in rays], panel.basis(), la.BEAM_MAX]
    assert_same(out["port"], out["jax"])


def test_persisted_state_matches_jax(tmp_path):
    """The screen layout json and the runtime keys written into a
    settings.yaml (the port through its own YAML writer) read back the same."""
    import yaml

    out = {}
    for pkg in PKGS:
        ps, g = xr(pkg, "persist"), xr(pkg, "geometry")
        d = tmp_path / pkg
        d.mkdir()
        prof = str(d / ps.BUILTIN_PROFILE)
        pose = g.ScreenPose(width=5.5, distance=4.2, pan_x=0.3, pan_y=-0.1, yaw=0.12,
                            pitch=-0.05)
        with open(prof, "w") as f:
            json.dump({"display_name": {"EN": "Mine"}}, f)
        wrote = [ps.persist_screen_state(prof, pose, curve_axis="horizontal", preset_index=2),
                 ps.persist_screen_state(prof, pose, locked=True)]
        with open(prof) as f:
            text = f.read()
        settings = d / "settings.yaml"
        settings.write_text("Model: Depth-Anything-V2-Small\nCustom Key: keepme\n")
        ps.persist_runtime_settings(str(settings), environment="Cinema", depth_strength=2.5,
                                    crop_mode="manual", controller="QUEST")
        out[pkg] = [wrote, text, ps.restore_screen_state(prof),
                    ps.restore_screen_state(str(d / "absent.json")),
                    ps.screen_state_dict(pose, "vertical", 3),
                    ps.runtime_settings_snapshot(environment="Cinema"),
                    yaml.safe_load(settings.read_text())]
    assert_same(out["port"], out["jax"])


# ---- the theater -------------------------------------------------------------------


def _frame(w=160, h=90):
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[:, :, 0] = 200
    rgb[h // 3:2 * h // 3, w // 3:2 * w // 3] = (30, 220, 40)
    return rgb


UI_CASES = [{}, {"glow": True}, {"passthrough": True}, {"curved": True},
            {"fps_overlay": True, "help_panel": True, "keyboard": True},
            {"overlays_hidden": True, "fps_overlay": True}, {"background": 3},
            {"effect_transparency": 0.4, "glow": True}]


def _theater(pkg, ui, **kw):
    th_mod, env = xr(pkg, "theater"), xr(pkg, "environment")
    th = th_mod.Theater(profile=bright_profile(env), **kw)
    th.ui.update(ui)
    th.set_stats(59.0, latency_ms=16.0)
    return th


@pytest.mark.parametrize("ui", UI_CASES)
def test_theater_frame_pixels_match_jax(ui):
    """Every toggle's draw list rendered by both rasterizers: the port's
    theater given the frame as a numpy array and as a tensor."""
    rgb = _frame()
    out = {}
    for pkg in PKGS:
        r, th_mod = xr(pkg, "raster"), xr(pkg, "theater")
        th = _theater(pkg, ui)
        th.frost_strength = 0.5 if ui.get("glow") else 0.0
        th.lasers = [th_mod.LaserBeam("right", np.array([0.2, 1.0, 0.0]),
                                      np.array([0.0, 0.0, -1.0]))]
        view = r.view_translate((0.032, th.origin_y, 0.0))
        proj = r.symmetric_proj(75.0, 160 / 90)
        imgs = []
        for tex in ([rgb, torch.from_numpy(rgb)] if pkg == "port" else [rgb]):
            clear, items = th.frame_items(tex, now=100.0)
            imgs.append((clear, [i.kind for i in items],
                         r.render_items(160, 90, clear, items, view, proj)))
        if pkg == "port":
            assert_same(imgs[1], imgs[0])
        clear, items = th.frame_items(rgb, gpu=True, dibr={"eye_offset": 0.032}, now=100.0)
        out[pkg] = [imgs[0], clear, [(i.kind, i.uniforms) for i in items]]
    assert_same(out["port"], out["jax"])


def test_theater_glb_scene_and_space_match_jax(tmp_path):
    room = tmp_path / "greenroom"
    room.mkdir()
    (room / "environment.glb").write_bytes(_glb_colored_wall())
    (room / "profile.json").write_text(json.dumps({"display_name": {"EN": "Green"}}))
    out = {}
    for pkg in PKGS:
        r, th_mod = xr(pkg, "raster"), xr(pkg, "theater")
        th = th_mod.Theater.from_env_dir(str(room))
        th.set_space("local")
        th.set_aspect(16 / 10)
        clear, items = th.frame_items(_frame())
        out[pkg] = [th.screen, th.origin_y, r.render_items(
            120, 68, clear, items, r.view_translate((0.0, th.origin_y, 0.0)),
            r.symmetric_proj(75.0, 120 / 68))]
    assert_same(out["port"], out["jax"])


def _compose_inputs(content):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:24, 0:48] / np.array([24.0, 48.0])[:, None, None]
    depth = (0.3 + 0.5 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.08)
             + 0.02 * rng.random((24, 48))).astype(np.float32)
    rgb = _frame(96, 48) if content == "flat" else (
        rng.random((48, 96, 3)) * 255).astype(np.uint8)
    return rgb, depth


@pytest.mark.parametrize("content", ["flat", "noise"])
@pytest.mark.parametrize("mode", ["Full-SBS", "Half-SBS"])
def test_soft_theater_compose_matches_jax(mode, content):
    """The CPU-rasterized theater around each warped eye, the port's warp
    and uint8 rounding on the device (here the CPU), JAX's in numpy.

    Exactly JAX's theater and rasterizer over the port's eye textures; and
    within 1 LSB of JAX's whole compose.  On the JAX suite's flat-coloured
    frame at most 0.1% of the values are off.  Noise content puts many of
    the warp's values on exact .5 ties (the vertical blend's quarter
    weights), which the port's float32 and the JAX client's partly float64
    arithmetic round apart (see test_torch_xr_client.py), so there only the
    1 LSB bound is held."""
    rgb, depth = _compose_inputs(content)
    out = {}
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg == "port" else {}
        comp = client(pkg).SoftTheaterCompositor(
            _theater(pkg, {"glow": True}), ipd=0.064, depth_strength=2.0, convergence=0.01,
            eye_size=(192, 108), mode=mode, **kw)
        out[pkg] = [comp.compose(rgb, depth), comp.compose(rgb, None)]

    # JAX's theater and rasterizer over the port's own eye textures
    tc, jr = client("port"), xr("jax", "raster")
    th = _theater("jax", {"glow": True})
    th.set_aspect(96 / 48)
    w = 192 if mode == "Full-SBS" else 96
    dep = tc._resize_bilinear(torch.from_numpy(depth), 48, 96)
    eyes = []
    for eye in (-1, 1):
        tex = tc.round_u8(tc.warp_eye(torch.from_numpy(rgb), dep, eye * 0.032, 2.0, 0.01))
        clear, items = th.frame_items(tex.numpy())
        eyes.append(jr.render_items(w, 108, clear, items,
                                    jr.view_translate((eye * 0.032, th.origin_y, 0.0)),
                                    jr.symmetric_proj(75.0, w / 108)))
    np.testing.assert_array_equal(out["port"][0], np.concatenate(eyes, axis=1))

    for got, want in zip(out["port"], out["jax"]):
        assert got.shape == want.shape == (108, 384 if mode == "Full-SBS" else 192, 3)
        lsb, share = u8_share(got, want)
        assert lsb <= 1 and (content == "noise" or share <= 1e-3), (lsb, share)
