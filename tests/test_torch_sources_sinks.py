"""The port's sources, sinks and native ring against the JAX package on the
CPU.

- synthetic frames byte-equal to the JAX source's for the same seed;
- image source and png sink round trips, both packages on the same files;
- null and tee sinks;
- the MJPEG sink's /mode, /strength, /feather, /stats and /stream endpoints
  driving a port `ProgramCache`'s live switches;
- the shared-memory ring written by the port and read by the JAX binding,
  and the other way round, and the port's shm source;
- the screen source with a fake X11 backend and the window sink with a fake
  cv2 (as `tests/test_screen_capture.py` and `tests/test_window_sink.py` do
  for the JAX package), each scenario run on both packages and compared;
- the video sink and source through one file; the viewer facade;
- the kinds that are not ported yet raise ValueError naming ROADMAP A1b.
"""

import http.client
import json
import os
import time

import numpy as np
import pytest
import torch

import desktop2stereo_tpu.core.display as J_display
import desktop2stereo_tpu.native as J_native
import desktop2stereo_tpu.sinks.png as J_png
import desktop2stereo_tpu.sinks.viewer as J_viewer
import desktop2stereo_tpu.sinks.window as J_window
import desktop2stereo_tpu.sources.image as J_image
import desktop2stereo_tpu.sources.screen as J_screen
import desktop2stereo_tpu.sources.synthetic as J_synthetic
import desktop2stereo_tpu.sources.video as J_video
import desktop2stereo_tpu_torch.core.display as T_display
import desktop2stereo_tpu_torch.native as T_native
import desktop2stereo_tpu_torch.sinks.png as T_png
import desktop2stereo_tpu_torch.sinks.viewer as T_viewer
import desktop2stereo_tpu_torch.sinks.window as T_window
import desktop2stereo_tpu_torch.sources.image as T_image
import desktop2stereo_tpu_torch.sources.screen as T_screen
import desktop2stereo_tpu_torch.sources.synthetic as T_synthetic
from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES
from desktop2stereo_tpu_torch.core.registry import ModelSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.factory import init_random
from desktop2stereo_tpu_torch.pipeline.programs import ProgramCache, ProgramConfig
from desktop2stereo_tpu_torch.sinks import make_sink
from desktop2stereo_tpu_torch.sinks.mjpeg import MjpegSink
from desktop2stereo_tpu_torch.sinks.null import NullSink
from desktop2stereo_tpu_torch.sinks.tee import TeeSink
from desktop2stereo_tpu_torch.sources import make_source
from desktop2stereo_tpu_torch.sources.shm import ShmSource
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(hidden_size=64, num_layers=4, num_heads=2, mlp_dim=128,
            out_layers=(0, 1, 2, 3), neck_channels=(16, 32, 64, 64), fusion_channels=32)


# ---- sources ---------------------------------------------------------------------

@pytest.mark.parametrize("size,channels,seed", [((72, 96), 4, 0), ((40, 30), 3, 3),
                                                ((330, 500), 4, 7)])
def test_synthetic_frames_equal_jax(size, channels, seed):
    t = T_synthetic.SyntheticSource(size=size, channels=channels, max_frames=6, seed=seed)
    j = J_synthetic.SyntheticSource(size=size, channels=channels, max_frames=6, seed=seed)
    for i in range(6):
        a, b = t.grab(), j.grab()
        assert a.dtype == np.uint8 and a.shape == (*size, channels)
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    assert t.grab() is None and j.grab() is None


@pytest.mark.parametrize("bgra", [True, False])
def test_image_source_equals_jax(tmp_path, bgra):
    from PIL import Image

    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "x.png")
    t = T_image.ImageSource(str(tmp_path / "x.png"), max_frames=2, bgra=bgra)
    j = J_image.ImageSource(str(tmp_path / "x.png"), max_frames=2, bgra=bgra)
    for _ in range(2):
        np.testing.assert_array_equal(t.grab(), j.grab())
    assert t.grab() is None and j.grab() is None
    if bgra:
        np.testing.assert_array_equal(
            T_image.ImageSource(str(tmp_path / "x.png")).grab()[..., 2::-1], rgb)


def test_video_sink_and_source_round_trip(tmp_path):
    """Frames the port's video sink writes read back through both packages'
    video sources alike (mp4v is lossy, so only their agreement is exact)."""
    path = str(tmp_path / "v.mp4")
    sink = make_sink("video", path=path, fps=10.0)
    rng = np.random.default_rng(2)
    for _ in range(4):
        sink.push(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), None, {})
    sink.close()
    t = make_source("video", path=path)
    j = J_video.VideoSource(path)
    frames = 0
    while (a := t.grab()) is not None:
        np.testing.assert_array_equal(a, j.grab())
        assert a.shape == (48, 64, 3)
        frames += 1
    assert frames == 4 and j.grab() is None
    t.close()
    j.close()


# ---- sinks ------------------------------------------------------------------------

def test_png_sink_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    t_sink = T_png.PngSink(str(tmp_path / "t"), every=2, save_depth=True, limit=3)
    j_sink = J_png.PngSink(str(tmp_path / "j"), every=2, save_depth=True, limit=3)
    assert t_sink.wants_depth and not T_png.PngSink(str(tmp_path / "n")).wants_depth
    frames = []
    for _ in range(8):
        sbs = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
        depth = rng.random((16, 24), dtype=np.float32) * 1.2 - 0.1
        frames.append(sbs)
        t_sink.push(sbs, depth, {})
        j_sink.push(sbs, depth, {})
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == [f"{k}_{i:06d}.png" for k in ("depth", "sbs") for i in (0, 2, 4)]
    from PIL import Image

    for name in names:
        a = np.asarray(Image.open(tmp_path / "t" / name))
        np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "j" / name)))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / "sbs_000002.png")),
                                  frames[2])


def test_null_sink():
    s = NullSink()
    assert not s.wants_depth
    s.push(np.zeros((4, 4, 3), np.uint8), None, {})
    assert s.frames == 1 and s.last_shape == (4, 4, 3)


def test_tee_sink_fans_out_and_propagates_errors():
    class Rec:
        wants_depth = False

        def __init__(self, url=None):
            self.frames, self.closed, self.url = [], False, url
            self.mode_switcher = None

        def push(self, sbs, depth, stats):
            self.frames.append(sbs)

        def close(self):
            self.closed = True

    class Boom(Rec):
        wants_depth = True

        def push(self, sbs, depth, stats):
            raise RuntimeError("window closed")

    a, b = Rec("http://a/"), Rec()
    tee = TeeSink([a, b])
    assert not tee.wants_depth and tee.url == "http://a/"
    tee.mode_switcher = "prog"
    assert a.mode_switcher == b.mode_switcher == tee.mode_switcher == "prog"
    frame = np.zeros((4, 6, 3), np.uint8)
    tee.push(frame, None, {})
    assert len(a.frames) == len(b.frames) == 1
    tee.close()
    assert a.closed and b.closed
    boom, ok = Boom(), Rec()
    tee2 = TeeSink([boom, ok])
    assert tee2.wants_depth
    with pytest.raises(RuntimeError):
        tee2.push(frame, None, {})
    assert len(ok.frames) == 1
    with pytest.raises(ValueError):
        TeeSink([])


@pytest.mark.parametrize("kind,make", [("tcp", make_source), ("rtmp", make_sink),
                                       ("xr", make_sink)])
def test_unported_kinds_name_a1b(kind, make):
    with pytest.raises(ValueError, match="A1b"):
        make(kind)


@pytest.mark.parametrize("make", [make_source, make_sink])
def test_unknown_kinds_raise(make):
    with pytest.raises(ValueError, match="unknown"):
        make("bogus")


@pytest.fixture
def port_cache():
    """A tiny Depth-Anything ProgramCache on the CPU (random weights)."""
    model = init_random(DepthAnything(**TINY), seed=0).eval()
    cfg = ProgramConfig(model_name="tiny", depth_resolution=56, output_height=64,
                        display_mode="Half-SBS", ipd=0.064, depth_strength=2.0,
                        convergence=0.0, foreground_scale=0.0, aa_strength=2.0,
                        ema_alpha=0.9, temporal_smooth=True, quality="high",
                        emit_depth="model")
    spec = ModelSpec(name="tiny", family="depth_anything", variant="vits", hf_repo="none")
    return ProgramCache(cfg, model, spec, compute_dtype=torch.float32)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, json.loads(body)


def test_mjpeg_endpoints_drive_a_port_program_cache(port_cache):
    sink = MjpegSink(port=0, fps=30.0, quality=80, host="127.0.0.1")
    try:
        assert _get(sink.port, "/mode")[0] == 503  # no pipeline attached yet
        assert _get(sink.port, "/strength")[0] == 503
        assert _get(sink.port, "/feather")[0] == 503
        sink.mode_switcher = port_cache
        status, body = _get(sink.port, "/mode")
        assert status == 200 and body == {"mode": "Half-SBS", "available": list(DISPLAY_MODES)}
        assert _get(sink.port, "/mode?set=Full-TAB") == (200, {"mode": "Full-TAB"})
        assert _get(sink.port, "/mode")[1]["mode"] == "Full-TAB"  # pending, reported
        assert _get(sink.port, "/mode?set=Bogus")[0] == 400
        assert _get(sink.port, "/strength?delta=0.5") == (200, {"depth_strength": 2.5})
        assert _get(sink.port, "/strength?set=99") == (200, {"depth_strength": 10.0})
        assert _get(sink.port, "/strength?set=2.47") == (200, {"depth_strength": 2.5})
        assert _get(sink.port, "/strength?set=bogus")[0] == 400
        assert _get(sink.port, "/feather") == (200, {"edge_feather": False})
        assert _get(sink.port, "/feather?toggle=1") == (200, {"edge_feather": True})
        # the switches apply at the next frame
        frame = np.random.default_rng(0).integers(0, 256, (64, 96, 4), dtype=np.uint8)
        sbs, _ = port_cache(frame)
        assert tuple(sbs.shape) == (128, 96, 3)  # Full-TAB
        cfg = port_cache.cfg
        assert (cfg.display_mode, cfg.depth_strength, cfg.edge_feather) == ("Full-TAB", 2.5, True)
        assert _get(sink.port, "/strength?reset=1") == (200, {"depth_strength": 2.0})

        assert _get(sink.port, "/stats") == (200, {})
        stats = {"fps": 42.5, "frames": 100, "dropped": 7, "latency": {"sink": 0.001}}
        sink.push(sbs.numpy(), None, stats)
        assert _get(sink.port, "/stats") == (200, stats)

        conn = http.client.HTTPConnection("127.0.0.1", sink.port, timeout=5)
        conn.request("GET", "/stream")
        r = conn.getresponse()
        assert r.status == 200 and "multipart/x-mixed-replace" in r.getheader("Content-Type")
        data, deadline = b"", time.time() + 5
        while time.time() < deadline and b"\xff\xd8" not in data:
            chunk = r.read(256)
            if not chunk:
                break
            data += chunk
            sink.push(sbs.numpy(), None, stats)
        assert b"--frame" in data and b"\xff\xd8" in data
        conn.close()
    finally:
        sink.close()


def test_viewer_facade_equals_jax():
    """The headless viewer's presented frame, with the FPS overlay, equals
    the JAX facade's."""
    t = T_viewer.StereoWindow(port=0, show_fps=True)
    j = J_viewer.StereoWindow(port=0, show_fps=True)
    try:
        frame = np.random.default_rng(6).integers(0, 256, (120, 320, 3), dtype=np.uint8)
        for sink in (t, j):
            sink.push(frame, None, {"fps": 57.3})
        np.testing.assert_array_equal(t.capture_glfw_image(), j.capture_glfw_image())
        assert not np.array_equal(t.capture_glfw_image(), frame)  # the overlay is there
        assert t.frame_count == 1 and not t.wants_depth
    finally:
        t.close()
        j.close()


# ---- the shared-memory ring ------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_shm_ring_across_bindings(writer, reader):
    mods = {"port": T_native, "jax": J_native}
    if mods["jax"].load() is None:
        pytest.fail("the JAX package's native library did not build")
    name = f"/d2s_test_{writer}_{reader}_{os.getpid()}"
    ring = mods[writer].ShmFrameRing(name, max_bytes=64 * 64 * 4, slots=3)
    try:
        rd = mods[reader].ShmFrameRing(name, create=False)
        assert rd.read_latest() is None
        frame = (np.arange(64 * 64 * 4, dtype=np.uint32).reshape(64, 64, 4) % 251).astype(np.uint8)
        assert ring.write(frame, timestamp_ns=1234) == 1
        out, ts = rd.read_latest()
        np.testing.assert_array_equal(out, frame)
        assert ts == 1234
        for i in range(5):  # latest wins
            ring.write(np.full((32, 16, 3), i, np.uint8))
        out, _ = rd.read_latest()
        assert out.shape == (32, 16, 3) and (out == 4).all()
        assert rd.read_latest() is None
        with pytest.raises(ValueError):
            ring.write(np.zeros((128, 128, 4), np.uint8))
        rd.close()
    finally:
        ring.close()


def test_port_shm_source_reads_the_jax_ring():
    name = f"/d2s_test_src_{os.getpid()}"
    ring = J_native.ShmFrameRing(name, max_bytes=8 * 8 * 4)
    try:
        ring.write(np.full((8, 8, 4), 7, np.uint8))
        src = ShmSource(name, timeout=1.0, max_frames=3)
        assert (src.grab() == 7).all()
        ring.write(np.full((8, 8, 4), 9, np.uint8))
        assert (src.grab() == 9).all()
        t0 = time.monotonic()
        assert src.grab() is None  # the producer wrote nothing newer: times out
        assert time.monotonic() - t0 >= 0.9
        src.close()
    finally:
        ring.close()


def test_native_library_is_built_into_the_package():
    path = T_native.library_path()
    assert path.parent == T_native.BUILD_DIR and path.name.startswith("d2s_native-")
    T_native.load()
    assert path.exists()


def test_native_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(T_native, "SOURCE", bad)
    monkeypatch.setattr(T_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        T_native.build()
    monkeypatch.setattr(T_native, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="not found"):
        T_native.build()


def test_frame_pacer():
    pacer = T_native.FramePacer(fps=200.0)
    t0 = time.perf_counter()
    for _ in range(10):
        pacer.wait()
    assert 0.04 < time.perf_counter() - t0 < 0.5


# ---- the screen source with a fake X11 ----------------------------------------------

class FakeX11:
    def __init__(self):
        self.size = (100, 200)  # (h, w)
        self.windows = {7: (10, 20, 64, 32)}
        self.titles = {7: "My Editor"}
        self.grab_calls = []
        self.root_grabs = 0
        self.cursor_img = None

    def find_window(self, needle):
        for wid, t in self.titles.items():
            if needle.lower() in t.lower():
                return wid
        return 0

    def window_rect(self, wid):
        return self.windows.get(wid)

    def grab_rect(self, x, y, w, h):
        self.grab_calls.append((x, y, w, h))
        f = np.zeros((h, w, 4), np.uint8)
        f[..., 0] = 7
        f[..., 1] = len(self.grab_calls)
        return f

    def grab(self):
        self.root_grabs += 1
        return np.full((*self.size, 4), 3, np.uint8)

    def cursor(self):
        return self.cursor_img

    def close(self):
        pass


def _screen(mod, fake, title="editor", cursor=True, mon_rect=None):
    src = mod.ScreenSource.__new__(mod.ScreenSource)
    src.max_frames = None
    src.window_title = title
    src.with_cursor = cursor
    src._i = 0
    src._native = fake
    src._sct = None
    src._mon = None
    src._last = None
    src._failures = 0
    src._window = fake.find_window(title) if title else 0
    src._window_lost = False
    src._rect = fake.window_rect(src._window) if src._window else None
    src._mon_rect = mon_rect
    return src


def _tracking(src, fake):
    """Jitter below the hysteresis, a move, a resize, the window gone (the
    stream freezes for longer than the failure budget), re-found under a new
    title."""
    out = [src.grab()]
    fake.windows[7] = (10 + 5, 20, 64, 32)
    out.append(src.grab())
    fake.windows[7] = (40, 25, 64, 32)
    out.append(src.grab())
    fake.windows[7] = (40, 25, 80, 40)
    out.append(src.grab())
    del fake.windows[7], fake.titles[7]
    out += [src.grab() for _ in range(src.MAX_CONSECUTIVE_FAILURES + 3)]
    fake.windows[11], fake.titles[11] = (2, 3, 50, 24), "Editor (restored)"
    out.append(src.grab())
    return out


def _cursor(src, fake):
    fake.cursor_img = (np.full((4, 4), 0x80FF00FF, np.uint32), 12, 22)
    return [src.grab()]


@pytest.mark.parametrize("scenario,kw", [
    (_tracking, {}), (_cursor, {}), (_cursor, {"title": None}),
    (_cursor, {"title": None, "mon_rect": (30, 10, 80, 50)}),
    (_cursor, {"title": None, "cursor": False})],
    ids=["window_tracking", "cursor_in_window", "cursor_root", "monitor_rect", "no_cursor"])
def test_screen_source_scenarios_equal_jax(scenario, kw):
    t_fake, j_fake = FakeX11(), FakeX11()
    t_out = scenario(_screen(T_screen, t_fake, **kw), t_fake)
    j_out = scenario(_screen(J_screen, j_fake, **kw), j_fake)
    assert len(t_out) == len(j_out)
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a, b)
    assert t_fake.grab_calls == j_fake.grab_calls
    assert t_fake.root_grabs == j_fake.root_grabs
    if scenario is _tracking:
        assert t_fake.root_grabs == 0  # a lost window never grabs the desktop
        assert t_fake.grab_calls[-1] == (2, 3, 50, 24)


def test_cursor_composite_equals_jax():
    rng = np.random.default_rng(8)
    frame = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
    cur = rng.integers(0, 2**32, (9, 7), dtype=np.uint64).astype(np.uint32)
    for x, y in ((3, 4), (-3, -2), (36, 25), (50, 50)):
        a, b = frame.copy(), frame.copy()
        T_screen.composite_cursor_bgra(a, cur, x, y)
        J_screen.composite_cursor_bgra(b, cur, x, y)
        np.testing.assert_array_equal(a, b)


# ---- the window sink with a fake cv2 ---------------------------------------------------

class FakeCv:
    WINDOW_NORMAL = 0
    WINDOW_FULLSCREEN = 1
    WND_PROP_FULLSCREEN = 2
    WINDOW_KEEPRATIO = 4

    def __init__(self, keys):
        self.shown, self.titles, self.props, self.saved, self.moves = [], [], [], [], []
        self.key_queue = list(keys)
        self.window_flags = []

    def namedWindow(self, _t, flags=0):
        self.window_flags.append(flags)

    def imshow(self, _t, img):
        self.shown.append(img.copy())

    def setWindowTitle(self, _t, new):
        self.titles.append(new)

    def setWindowProperty(self, _t, prop, val):
        self.props.append((prop, val))

    def waitKeyEx(self, _ms):
        return self.key_queue.pop(0) if self.key_queue else -1

    waitKey = waitKeyEx

    def imwrite(self, path, img):
        self.saved.append(img.copy())
        return True

    def destroyWindow(self, _t):
        pass

    def moveWindow(self, _t, x, y):
        self.moves.append((x, y))

    def getWindowImageRect(self, _t):
        return (10, 10, 640, 480)


class FakeProgram:
    def __init__(self, mode="Half-SBS"):
        self.display_mode = mode
        self.calls = []
        self.strength = 2.0

    def set_display_mode(self, m):
        self.display_mode = m
        self.calls.append(m)

    def cycle_display_mode(self, delta=1):
        i = (DISPLAY_MODES.index(self.display_mode) + delta) % len(DISPLAY_MODES)
        self.set_display_mode(DISPLAY_MODES[i])
        return DISPLAY_MODES[i]

    def adjust_depth_strength(self, d):
        self.strength += d
        self.calls.append(("adjust", d))
        return self.strength

    def reset_depth_strength(self):
        self.strength = 2.0
        self.calls.append("reset")
        return 2.0

    def toggle_feather(self):
        self.calls.append("feather")
        return len(self.calls) % 2 == 1


def _window(mod, keys, program=None, fill=False, tmp=".", mode="Half-SBS"):
    fake = FakeCv(keys)
    sink = mod.WindowSink.__new__(mod.WindowSink)
    sink._cv = fake
    sink.title = "t"
    sink.screenshot_dir = str(tmp)
    sink._fullscreen = False
    sink._created = False
    sink._last_title = 0.0
    sink.frames = 0
    sink.mode_switcher = FakeProgram(mode) if program else None
    sink.keep_aspect = False
    sink.fill_16_9 = fill
    sink._show_rgb_in_depth = False
    return sink, fake


_F, _S, _TAB, _ENTER, _UP, _DOWN_VK, _LEFT_VK, _RIGHT = (
    ord("f"), ord("s"), 9, 13, 65362, 2621440, 2424832, 65363)


@pytest.mark.parametrize("keys,program,fill,mode,shape", [
    ([_F, _S, ord(" "), _ENTER], False, False, "Half-SBS", (4, 6, 3)),
    ([ord("m"), ord("5"), _TAB, ord("9"), ord("1")], True, False, "Half-SBS", (2, 2, 3)),
    ([ord("+"), ord("-"), ord("0"), ord("="), _UP, _DOWN_VK], True, False, "Half-SBS", (2, 2, 3)),
    ([ord("b"), ord("b")], True, False, "Half-SBS", (2, 2, 3)),
    ([ord("d"), ord("d"), ord("d"), ord("3"), ord("d")], True, False, "Depth", (2, 2, 3)),
    ([ord("d")], True, False, "Half-SBS", (2, 2, 3)),
    ([255, ord("a"), 255], False, True, "Half-SBS", (90, 90, 3)),
    ([255, ord("a"), 255], False, True, "Half-SBS", (10, 320, 3)),
    ([ord("l"), 255, ord("l")], False, False, "Half-SBS", (2, 2, 3)),
    ([_RIGHT, _LEFT_VK, _F, _RIGHT], False, False, "Half-SBS", (2, 2, 3)),
], ids=["fullscreen_screenshot", "mode_keys", "strength_keys", "feather", "depth_rgb_toggle",
        "depth_key_inert", "fill_16_9_square", "fill_16_9_wide", "aspect_lock", "monitor_move"])
def test_window_sink_keys_equal_jax(monkeypatch, tmp_path, keys, program, fill, mode, shape):
    mons = [("eDP-1", 0, 0, 1920, 1080), ("HDMI-1", 1920, 0, 2560, 1440)]
    for mod in (J_display, T_display):
        monkeypatch.setattr(mod, "list_monitors", lambda: mons)
    rng = np.random.default_rng(len(keys))
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in keys]
    results = []
    for mod in (T_window, J_window):
        sink, fake = _window(mod, keys, program, fill, tmp_path, mode)
        for i, frame in enumerate(frames):
            sink.push(frame, None, {"fps": 59.9, "fps_1pct_low": 48.2, "dropped": i})
        results.append((sink, fake))
    (ts, tf), (js, jf) = results
    assert len(tf.shown) == len(jf.shown) == len(keys)
    for a, b in zip(tf.shown, jf.shown):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tf.saved, jf.saved):
        np.testing.assert_array_equal(a, b)
    assert (tf.titles, tf.props, tf.moves, tf.window_flags, len(tf.saved)) == (
        jf.titles, jf.props, jf.moves, jf.window_flags, len(jf.saved))
    assert (ts.fill_16_9, ts.keep_aspect, ts._fullscreen, ts._show_rgb_in_depth, ts.frames) == (
        js.fill_16_9, js.keep_aspect, js._fullscreen, js._show_rgb_in_depth, js.frames)
    if program:
        assert ts.mode_switcher.calls == js.mode_switcher.calls
        # the keys reached the program, bar 'd' outside Depth mode
        assert bool(ts.mode_switcher.calls) == (keys != [ord("d")])


def test_window_sink_quit_and_headless(monkeypatch):
    sink, _ = _window(T_window, [ord("q")])
    with pytest.raises(T_window.WindowCloseRequested):
        sink.push(np.zeros((2, 2, 3), np.uint8), None, {})
    sink, _ = _window(T_window, [27])
    with pytest.raises(T_window.WindowCloseRequested):
        sink.push(np.zeros((2, 2, 3), np.uint8), None, {})
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises((RuntimeError, ImportError)):
        T_window.WindowSink()


def test_window_sink_keys_switch_a_port_program_cache(port_cache):
    """m cycles, 3 selects Half-TAB, + steps the strength, b toggles the
    feather: applied at the cache's next frame."""
    sink, _ = _window(T_window, [ord("m"), ord("3"), ord("+"), ord("b")])
    sink.mode_switcher = port_cache
    for _ in range(4):
        sink.push(np.zeros((2, 2, 3), np.uint8), None, {})
    sbs, _ = port_cache(np.zeros((64, 96, 4), np.uint8))
    cfg = port_cache.cfg
    assert (cfg.display_mode, cfg.depth_strength, cfg.edge_feather) == ("Half-TAB", 2.5, True)
    assert tuple(sbs.shape) == (64, 96, 3)
