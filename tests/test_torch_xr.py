"""The port's XR serving side against the JAX package on the CPU: the frame
mailbox (`xr/frame_server.py`), the frame protocol (`xr/net.py`), the input
injectors and bridge (`xr/injector.py`), the XR sink (`sinks/xr.py`), and
the remote topology through both CLIs.

- the frame protocol: `_encode_rgb`, `_encode_depth` and `_serialize` give
  JAX's bytes; the port's server answers the JAX client and the JAX server
  the port's client (raw and JPEG frames, depth at its own resolution, the
  meta query, the input ack), and the port's copy of `tests/test_xr_net.py`;
- the input bridge: one scripted session (moves, clicks, a drag, scroll,
  keys with modifiers, taps, arrows, a two-trigger pinch spread and closed),
  drawn from the JAX client's router, through both bridges onto recording
  injectors, with and without a touch injector: the recorded calls are
  equal; the VK → keysym table equals JAX's; a host without a display gives
  no injector, a failed native build raises;
- the XR sink: the input state in its url, frames and depth to a client of
  either package, its CLI kwargs (meta from the settings, `--xr-no-input`)
  as JAX's;
- end to end: a 3-frame synthetic stream over loopback into both CLIs'
  `run()` (`--source tcp:0 --sink xr --device cpu`) on one tiny
  Depth-Anything's weights; the frames the two clients receive agree
  within `tests/test_torch_cli.py`'s tolerances (SBS at most 3 LSB with
  under 1% of values more than 1 LSB off; depth within 5e-3).

Every wait is bounded by events and counts, with a generous timeout.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import desktop2stereo_tpu.cli as J_cli
import desktop2stereo_tpu.core.config as J_config
import desktop2stereo_tpu.core.runtime as J_runtime
import desktop2stereo_tpu.models.factory as J_factory
import desktop2stereo_tpu.ops.pallas.dibr as J_dibr
import desktop2stereo_tpu.ops.stereo as J_stereo
import desktop2stereo_tpu.pipeline.programs as J_programs
import desktop2stereo_tpu.sinks as J_sinks
import desktop2stereo_tpu.sources as J_sources
import desktop2stereo_tpu.sources.synthetic as J_synthetic
import desktop2stereo_tpu.xr.frame_server as J_fs
import desktop2stereo_tpu.xr.injector as J_inj
import desktop2stereo_tpu.xr.net as J_xnet
import desktop2stereo_tpu_torch.cli as T_cli
import desktop2stereo_tpu_torch.core.config as T_config
import desktop2stereo_tpu_torch.models.factory as T_factory
import desktop2stereo_tpu_torch.sinks as T_sinks
import desktop2stereo_tpu_torch.sources as T_sources
import desktop2stereo_tpu_torch.xr.frame_server as T_fs
import desktop2stereo_tpu_torch.xr.injector as T_inj
import desktop2stereo_tpu_torch.xr.net as T_xnet
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu.xr.input_router import HandInput, OsInputRouter
from desktop2stereo_tpu.xr.keyboard import VK, build_layout
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.sinks.xr import XrSink
from desktop2stereo_tpu_torch.sources.net import TcpFrameSender
from test_torch_cli import SETTINGS, SPEC, TINY, _Counted, _run_keeping_signals, _seeded_params
from torch_threads import one_torch_thread  # noqa: F401

WAIT_S = 60.0
PKG = {"jax": (J_fs, J_xnet), "port": (T_fs, T_xnet)}


def _served(pkg, **kw):
    fs_mod, net_mod = PKG[pkg]
    fs = fs_mod.FrameServer()
    return fs, net_mod.FrameNetServer(fs, host="127.0.0.1", port=0, **kw).start()


def _rgb_depth(seed, h=48, w=64, dh=None, dw=None):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 255, (h, w, 3), np.uint8)
    depth = rng.random((dh or h, dw or w)).astype(np.float32)
    return rgb, depth


# ---- the wire against JAX ------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["raw", "jpeg"])
def test_encoders_match_jax(encoding):
    rgb, depth = _rgb_depth(0, dh=24, dw=32)
    for arr in (rgb, rgb.astype(np.float32) + 300.0):  # non-u8 frames are clipped
        payload, used = T_xnet._encode_rgb(arr, encoding)
        assert (bytes(payload), used) == J_xnet._encode_rgb(arr, encoding)
    for d in (depth, depth * 3 - 1, None):  # out-of-range depth is clamped
        assert T_xnet._encode_depth(d) == J_xnet._encode_depth(d)
    buf = J_xnet._encode_depth(depth)
    np.testing.assert_array_equal(T_xnet._decode_depth(buf, 24, 32),
                                  J_xnet._decode_depth(buf, 24, 32))
    assert T_xnet._decode_depth(b"", 24, 32) is None


def test_decoded_depth_encodes_to_the_same_bytes():
    """A client that re-encodes the depth it decoded gets the bytes the
    server sent (chip_smoke.py matches the XR client's frames to the pushed
    ones by the CRC-32 of these bytes), at every u16 step and in between."""
    steps = np.arange(65536, dtype=np.float32) / 65535.0
    rng = np.random.default_rng(3)
    for d in (steps.reshape(256, 256), rng.random((294, 518)).astype(np.float32)):
        buf = T_xnet._encode_depth(d)
        back = T_xnet._decode_depth(buf, *d.shape)
        assert T_xnet._encode_depth(back) == buf == J_xnet._encode_depth(back)


@pytest.mark.parametrize("encoding", ["raw", "jpeg"])
@pytest.mark.parametrize("with_depth", [True, False])
def test_serialized_responses_match_jax(encoding, with_depth):
    rgb, depth = _rgb_depth(1, dh=24, dw=32)
    d = depth if with_depth else None
    jp = J_fs.FramePacket(rgb, d, 7, 123.5)
    tp = T_fs.FramePacket(rgb, d, 7, 123.5)
    # the port's response is a list of buffers written in turn
    assert (b"".join(T_xnet.FrameNetServer._serialize(tp, 6, encoding))
            == J_xnet.FrameNetServer._serialize(jp, 6, encoding))
    assert (b"".join(T_xnet.FrameNetServer._serialize(None, 6, encoding))
            == J_xnet.FrameNetServer._serialize(None, 6, encoding))


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_protocol_across_packages(server, client):
    """Frames with depth at its own resolution, a poll with nothing new,
    latest-wins, JPEG, the meta query and the input ack, across packages."""
    meta = {"ipd": 0.07, "depth_strength": 3.0, "convergence": 0.0,
            "environment": "Cinema", "controller": "PICO"}
    events = []
    fs, srv = _served(server, meta=meta, on_input=events.extend)
    c = PKG[client][1].FrameNetClient(port=srv.port, encoding="raw")
    try:
        assert c.meta() == meta
        rgb, depth = _rgb_depth(2, h=48, w=128, dh=24, dw=32)  # SBS + model-res depth
        fs.update_frame(rgb, depth)
        pkt = c.poll(timeout=WAIT_S)
        assert pkt is not None and pkt.seq == 1
        np.testing.assert_array_equal(pkt.rgb, rgb)
        assert pkt.depth.shape == (24, 32) and pkt.depth.dtype == np.float32
        np.testing.assert_allclose(pkt.depth, depth, atol=1.0 / 65535)
        assert c.poll(timeout=0.05) is None  # nothing newer; last_seen stays
        for i in range(5):  # a slow client jumps to the newest frame
            fs.update_frame(np.full((8, 8, 3), i * 40, np.uint8), None)
        pkt = c.poll(timeout=WAIT_S)
        assert pkt.seq == 6 and pkt.rgb[0, 0, 0] == 160 and pkt.depth is None
        assert c.send_input([{"t": "move", "u": 0.5, "v": 0.5}]) is True
        assert events == [{"t": "move", "u": 0.5, "v": 0.5}]
        assert srv.inputs_received == 1
        assert c.meta() == meta  # mid-stream too
        c.encoding = "jpeg"
        smooth = np.full((32, 48, 3), 128, np.uint8)
        smooth[:16] = [255, 0, 0]
        fs.update_frame(smooth, None)
        pkt = c.poll(timeout=WAIT_S)
        assert pkt.rgb.shape == (32, 48, 3)
        assert abs(int(pkt.rgb[:16, :, 0].astype(int).mean()) - 255) < 20
    finally:
        c.close()
        srv.close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_input_channel_acks_false_without_handler(server):
    _, srv = _served(server)
    c = T_xnet.FrameNetClient(port=srv.port)
    try:
        assert c.send_input([{"t": "move", "u": 0, "v": 0}]) is False
        assert c.send_input([]) is True  # nothing to send
    finally:
        c.close()
        srv.close()


# ---- the port's copy of tests/test_xr_net.py -------------------------------------------


@pytest.fixture
def port_served():
    fs, srv = _served("port")
    yield fs, srv
    srv.close()


def test_raw_roundtrip_with_depth(port_served):
    fs, srv = port_served
    rgb, depth = _rgb_depth(0)
    fs.update_frame(rgb, depth)
    c = T_xnet.FrameNetClient(port=srv.port, encoding="raw")
    try:
        pkt = c.poll(timeout=WAIT_S)
        np.testing.assert_array_equal(pkt.rgb, rgb)
        np.testing.assert_allclose(pkt.depth, depth, atol=1.0 / 65535)
        assert c.poll(timeout=0.05) is None
        fs.update_frame(rgb // 2, None)
        pkt2 = c.poll(timeout=WAIT_S)
        assert pkt2 is not None and pkt2.seq == pkt.seq + 1 and pkt2.depth is None
    finally:
        c.close()


def test_depth_rides_at_its_own_resolution(port_served):
    fs, srv = port_served
    rgb, depth = _rgb_depth(1, h=48, w=128, dh=24, dw=32)
    fs.update_frame(rgb, depth)
    c = T_xnet.FrameNetClient(port=srv.port, encoding="raw")
    try:
        pkt = c.poll(timeout=WAIT_S)
        assert pkt.rgb.shape == (48, 128, 3) and pkt.depth.shape == (24, 32)
        np.testing.assert_allclose(pkt.depth, depth, atol=1.0 / 65535)
    finally:
        c.close()


def test_jpeg_encoding_roundtrip(port_served):
    fs, srv = port_served
    rgb = np.full((32, 48, 3), 128, np.uint8)
    rgb[:16] = [255, 0, 0]
    fs.update_frame(rgb, None)
    c = T_xnet.FrameNetClient(port=srv.port, encoding="jpeg")
    try:
        pkt = c.poll(timeout=WAIT_S)
        assert pkt.rgb.shape == (32, 48, 3)
        assert abs(int(pkt.rgb[:16, :, 0].astype(int).mean()) - 255) < 20
        assert abs(int(pkt.rgb[20:, :, 1].astype(int).mean()) - 128) < 20
    finally:
        c.close()


def test_latest_wins_across_slow_client(port_served):
    fs, srv = port_served
    c = T_xnet.FrameNetClient(port=srv.port, encoding="raw")
    try:
        for i in range(5):
            fs.update_frame(np.full((8, 8, 3), i * 40, np.uint8), None)
        pkt = c.poll(timeout=WAIT_S)
        assert pkt.rgb[0, 0, 0] == 160 and pkt.seq == 5
    finally:
        c.close()


def test_encode_rgb_reports_actual_encoding():
    rgb = np.zeros((8, 8, 3), np.uint8)
    assert T_xnet._encode_rgb(rgb, "raw")[1] == "raw"
    assert T_xnet._encode_rgb(rgb, "jpeg")[1] == "jpeg"
    payload, used = T_xnet._encode_rgb(rgb.astype(np.float32) + 300.0, "jpeg")
    assert used in ("jpeg", "raw") and payload


def test_frame_server_wakes_promptly_on_publish():
    """Lost-wakeup regression: a frame published while the consumer waits
    ends the wait, instead of the wait running out its timeout."""
    fs = T_fs.FrameServer()
    fs.update_frame(np.zeros((4, 4, 3), np.uint8))
    first = fs.latest()
    assert fs.latest(last_seen=first.seq) is None  # non-blocking: nothing new
    t = threading.Timer(0.05, fs.update_frame, (np.ones((4, 4, 3), np.uint8),))
    t.start()
    t0 = time.monotonic()
    pkt = fs.latest(last_seen=first.seq, timeout=WAIT_S)
    elapsed = time.monotonic() - t0
    t.join(WAIT_S)
    assert pkt is not None and pkt.seq == first.seq + 1 and fs.frames_served == 2
    assert elapsed < WAIT_S / 2, f"waited {elapsed:.2f}s for an arrived frame"


def test_frame_server_write_and_close():
    fs = T_fs.FrameServer()
    fs.write(np.zeros((2, 6, 3), np.uint8), np.full((2, 3), 0.5, np.float64))
    pkt = fs.latest()
    assert pkt.depth.dtype == np.float32 and pkt.rgb.shape == (2, 6, 3)
    fs.close()
    assert fs.latest(last_seen=pkt.seq, timeout=0.01) is None


# ---- the input bridge against JAX ------------------------------------------------------


def _hand(u, v, trigger=0.0):
    return HandInput(screen_uv=(u, v), plane_uv=(u, v), screen_dist=3.0, trigger=trigger)


def _session():
    """Wire event batches of one scripted session, from the JAX client's
    router: moves, a click, a drag, scroll, keyboard taps with the shift
    latch, arrows, a two-trigger pinch spread and one closed; plus key
    down/up events with modifiers."""
    r = OsInputRouter((1920, 1080))
    keys = {k.label: k for k in build_layout()}
    batches, now = [], 0.0

    def step(hands, **kw):
        nonlocal now
        now += 0.05
        batches.append(r.update(hands, now=now, **kw))

    step({"right": _hand(0.5, 0.5)})
    step({"right": _hand(0.5, 0.5, 1.0)})
    step({"right": _hand(0.5, 0.5, 0.0)})
    step({"right": _hand(0.2, 0.7)})
    step({"right": _hand(0.2, 0.7, 1.0)})
    step({"right": _hand(0.4, 0.6, 1.0)})  # drag
    step({"right": _hand(0.4, 0.6, 0.0)})
    for _ in range(12):
        step({}, scroll_xy=(-0.6, 1.0), dt=1 / 30.0)
    for label in ("Shift", "A", "B"):
        step({"right": HandInput(kb_key=keys[label], kb_dist=0.4, trigger=1.0)})
        step({"right": HandInput(kb_key=keys[label], kb_dist=0.4, trigger=0.0)})
    step({}, arrow_xy=(1.0, 0.0))
    step({}, arrow_xy=(0.0, -1.0))
    for spans in ((0.1, 0.15, 0.22, 0.3), (0.3, 0.2, 0.1, 0.05)):
        for span in spans:
            step({"left": _hand(0.5 - span, 0.5, 1.0), "right": _hand(0.5 + span, 0.5, 1.0)})
        step({"left": _hand(0.2, 0.5, 0.0), "right": _hand(0.8, 0.5, 0.0)})
    batches.append([{"t": "key", "vk": VK["C"], "mods": [VK["Ctrl"], VK["Shift"]],
                     "down": True},
                    {"t": "key", "vk": VK["C"], "mods": [VK["Ctrl"], VK["Shift"]],
                     "down": False},
                    {"t": "scroll", "dy": -2, "dx": 3},
                    {"t": "button", "b": 3, "down": True},
                    {"t": "button", "b": 3, "down": False},
                    {"t": "unknown"}])
    return batches


@pytest.mark.parametrize("touch", [True, False])
def test_bridge_records_the_jax_calls(touch):
    batches = _session()
    kinds = {e["t"] for b in batches for e in b}
    assert {"move", "button", "scroll", "tap", "touch", "key"} <= kinds
    out = []
    for mod in (J_inj, T_inj):
        inj = mod.RecordingInjector(screen_size=(1920, 1080))
        tj = mod.RecordingTouchInjector(screen_size=(1920, 1080)) if touch else None
        bridge = mod.InputBridge(inj, touch_injector=tj)
        for b in batches:
            bridge.handle(b)
        out.append((inj.events, tj.events if tj else None, bridge.events_handled))
    assert out[0] == out[1]
    events, touches, _ = out[1]
    if touch:
        assert touches.count(("frame",)) >= 8
    else:  # the pinch became ctrl+wheel zoom: in (spread) and out (closed)
        assert events.count(("button", 4, True)) >= 2 and events.count(("button", 5, True)) >= 2


def test_bridge_scales_to_a_given_screen_like_jax():
    ev = [{"t": "move", "u": 0.25, "v": 0.75}, {"t": "touch", "id": 0, "u": 0.1, "v": 0.2,
                                                 "phase": "down"}]
    out = []
    for mod in (J_inj, T_inj):
        inj, tj = mod.RecordingInjector(), mod.RecordingTouchInjector()
        mod.InputBridge(inj, screen_size=(1000, 500), touch_injector=tj).handle(ev)
        out.append((inj.events, tj.events))
    assert out[0] == out[1] == ([("move", 250, 374)], [("touch", 0, 100, 100, True), ("frame",)])
    # no injector at all: events are dropped quietly
    T_inj.InputBridge(None).handle(ev)


def test_vk_keysym_table_matches_jax():
    for vk in range(256):
        assert T_inj.vk_to_keysym(vk) == J_inj.vk_to_keysym(vk), hex(vk)
    for key in build_layout():
        assert T_inj.vk_to_keysym(key.vk) is not None, key.label


def test_injectors_on_a_host_without_a_display(monkeypatch):
    """No display (or XTest, or uinput): None, the sink serves frames only.
    A native library that fails to build raises instead."""
    monkeypatch.delenv("DISPLAY", raising=False)
    assert T_inj.make_injector() is None
    assert T_inj.make_touch_injector((1920, 1080)) is None or hasattr(
        T_inj.make_touch_injector((1920, 1080)), "touch")

    class NoDisplay:
        def d2s_input_open(self, display):
            return None

        def d2s_touch_open(self, w, h):
            return None

    monkeypatch.setattr(T_inj, "load", lambda: NoDisplay())
    with pytest.raises(T_inj.InjectionUnavailable):
        T_inj.XTestInjector()
    assert T_inj.make_injector() is None and T_inj.make_touch_injector() is None

    def failed_build():
        raise RuntimeError("g++ failed for d2s_native.cpp")

    monkeypatch.setattr(T_inj, "load", failed_build)
    for make in (T_inj.make_injector, T_inj.make_touch_injector):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            make()


def test_xtest_injector_drives_the_native_entry_points(monkeypatch):
    """XTestInjector / UinputTouchInjector call the native entry points with
    the keysyms and coordinates JAX's would."""
    calls = []

    class FakeLib:
        """Records each call; handles are 1, and byref arguments are left out."""

        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, *[a for a in args if not hasattr(a, "_obj")]))
                return 1
            return fn

        def d2s_input_screen_size(self, handle, w, h):
            w._obj.value, h._obj.value = 1280, 720

    monkeypatch.setattr(T_inj, "load", lambda: FakeLib())
    inj = T_inj.XTestInjector(":9")
    assert inj.screen_size == (1280, 720)
    inj.move(3, 4)
    inj.button(1, True)
    inj.key_vk(VK["A"], True)
    inj.key_vk(0xFE, True)  # no keysym: nothing injected
    inj.close()
    inj.close()
    tj = T_inj.UinputTouchInjector((1280, 720))
    tj.touch(1, 5, 6, False)
    tj.frame()
    tj.close()
    assert calls == [("d2s_input_open", b":9"), ("d2s_input_move", 1, 3, 4),
                     ("d2s_input_button", 1, 1, 1), ("d2s_input_key", 1, 0x61, 1),
                     ("d2s_input_close", 1), ("d2s_touch_open", 1280, 720),
                     ("d2s_touch_point", 1, 1, 5, 6, 0), ("d2s_touch_frame", 1),
                     ("d2s_touch_close", 1)]


def test_input_channel_over_tcp_into_the_bridge():
    inj = T_inj.RecordingInjector()
    bridge = T_inj.InputBridge(inj, screen_size=(1000, 1000))
    _, srv = _served("port", on_input=bridge.handle)
    c = J_xnet.FrameNetClient(host="127.0.0.1", port=srv.port)
    try:
        assert c.send_input([{"t": "move", "u": 0.5, "v": 0.5},
                             {"t": "button", "b": 1, "down": True}])
        assert inj.events == [("move", 500, 500), ("button", 1, True)]
    finally:
        c.close()
        srv.close()


# ---- the XR sink ---------------------------------------------------------------------


def test_xr_sink_advertises_input_state():
    inj = T_inj.RecordingInjector()
    sink = XrSink(port=0, host="127.0.0.1", injector=inj)
    try:
        assert sink.url == f"tcp://127.0.0.1:{sink.port} (xr frame protocol, input: XTest)"
        assert sink.bridge is not None and sink.wants_depth
    finally:
        sink.close()
    assert inj.events == [("close",)]  # the injector is released
    sink2 = XrSink(port=0, inject_input=False)
    try:
        assert sink2.bridge is None and "input: none (headless)" in sink2.url
    finally:
        sink2.close()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_xr_sink_serves_frames_and_depth(client):
    sink = XrSink(port=0, host="127.0.0.1", inject_input=False, meta={"ipd": 0.05})
    c = PKG[client][1].FrameNetClient(port=sink.port)
    try:
        rgb, depth = _rgb_depth(3, h=16, w=64, dh=8, dw=16)
        sink.push(rgb, depth, {})
        pkt = c.poll(timeout=WAIT_S)
        np.testing.assert_array_equal(pkt.rgb, rgb)
        np.testing.assert_allclose(pkt.depth, depth, atol=1.0 / 65535)
        assert c.meta() == {"ipd": 0.05}
        assert sink.frames.frames_served == 1
    finally:
        c.close()
        sink.close()


@pytest.mark.parametrize("argv,extra", [
    ([], {}),
    (["--xr-no-input", "--port", "1200"], {"Environment Model": "Cinema",
                                           "Controller Model": "PICO"}),
])
def test_xr_sink_kwargs_match_jax(argv, extra):
    settings = {}
    for mod, config in ((T_cli, T_config), (J_cli, J_config)):
        s = config.Settings(ipd=0.07, depth_strength=3.5, convergence=0.02,
                            display_mode="Mono", foreground_scale_10=4.0)
        s.extra.update(extra)
        settings[mod] = mod._sink_kwargs("xr", mod.build_parser().parse_args(argv), s)
    assert settings[T_cli] == settings[J_cli]
    # --port 0 binds a free port in the port (the JAX CLI reads 0 as unset)
    kw = T_cli._sink_kwargs("xr", T_cli.build_parser().parse_args(["--port", "0"]),
                            T_config.Settings())
    assert kw["port"] == 0


# ---- end to end: both CLIs over loopback --------------------------------------------------

FRAME = (360, 640)


def _remote_run(monkeypatch, sources, sinks, client_net, run, argv, frames, out):
    """`run(argv)` with the tcp source and xr sink recorded as they are made;
    a thread streams `frames` over loopback, one each time the sink has
    served the frame before, and a client of `client_net` collects them."""
    made, ready = {}, threading.Event()
    make_source, make_sink = sources.make_source, sinks.make_sink

    def rec_source(kind, **kw):
        made["source"] = make_source(kind, **kw)
        return made["source"]

    def rec_sink(kind, **kw):
        if sinks is J_sinks:
            assert kw["port"] == 1123  # the JAX CLI reads --port 0 as unset
            kw["port"] = 0
        made["sink"] = make_sink(kind, **kw)
        ready.set()
        return made["sink"]

    monkeypatch.setattr(sources, "make_source", rec_source)
    monkeypatch.setattr(sinks, "make_sink", rec_sink)
    errors = []

    def agent():
        try:
            assert ready.wait(WAIT_S)
            snd = TcpFrameSender("127.0.0.1", made["source"].port)
            client = client_net.FrameNetClient(port=made["sink"].port)
            try:
                out["meta"] = client.meta()
                for f in frames:
                    snd.send(f)
                    deadline = time.monotonic() + WAIT_S
                    pkt = None
                    while pkt is None and time.monotonic() < deadline:
                        pkt = client.poll(timeout=1.0)
                    assert pkt is not None, "no frame served"
                    out.setdefault("packets", []).append(pkt)
            finally:
                client.close()
                snd.close()
        except BaseException as e:  # re-raised in the test below
            errors.append(e)

    t = threading.Thread(target=agent)
    t.start()
    rc = _run_keeping_signals(run, argv)
    t.join(WAIT_S)
    assert not t.is_alive()
    if errors:
        raise errors[0]
    out["stats"] = made["source"].stats()
    return rc


def test_remote_topology_end_to_end_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    settings = tmp_path / "settings.yaml"
    T_config.update_yaml(settings, SETTINGS)
    params = _seeded_params(JDepthAnything(**TINY), jnp.zeros((1, 28, 42, 3), jnp.float32))
    model = DepthAnything(**TINY).eval()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)), strict=True)

    counted = _Counted(J_dibr.dibr_render_pair_planar)
    monkeypatch.setattr(J_dibr, "dibr_render_pair_planar", counted)
    monkeypatch.setattr(J_programs, "_stereo_on_tpu", lambda: True)
    monkeypatch.setattr(J_stereo, "_on_tpu", lambda: True)
    monkeypatch.setattr(J_cli, "_apply_device_choice", lambda device: None)
    monkeypatch.setattr(J_runtime, "setup_compilation_cache", lambda *a: "")
    monkeypatch.setattr(J_factory, "build_bound", lambda name, **kw: (
        J_programs.BoundModel.stateless(JDepthAnything(**TINY).apply, params), JSpec(**SPEC)))
    monkeypatch.setattr(T_factory, "build_bound", lambda name, **kw: (model, TSpec(**SPEC)))

    synth = J_synthetic.SyntheticSource(size=FRAME)
    frames = [synth.grab().copy() for _ in range(3)]
    argv = ["--settings", str(settings), "--source", "tcp:0", "--sink", "xr", "--port", "0",
            "--xr-no-input", "--frames", "3", "--fp32", "--stats-every", "0",
            "--device", "cpu"]
    outs = {"jax": {}, "port": {}}
    assert _remote_run(monkeypatch, J_sources, J_sinks, J_xnet, J_cli.run, argv, frames,
                       outs["jax"]) == 0
    assert counted.calls > 0
    assert _remote_run(monkeypatch, T_sources, T_sinks, T_xnet, T_cli.run, argv, frames,
                       outs["port"]) == 0

    j, t = outs["jax"], outs["port"]
    assert t["meta"] == j["meta"] and t["meta"]["display_mode"] == "Half-SBS"
    for o in (j, t):
        assert o["stats"]["frames_received"] == o["stats"]["frames_delivered"] == 3
        assert [p.seq for p in o["packets"]] == [1, 2, 3]
    # the frames differ (the synthetic scene moves), so the EMA carry matters
    assert not np.array_equal(j["packets"][0].rgb, j["packets"][1].rgb)
    for pj, pt in zip(j["packets"], t["packets"]):
        assert pt.rgb.shape == pj.rgb.shape == (180, 320, 3)
        diff = np.abs(pt.rgb.astype(np.int32) - pj.rgb.astype(np.int32))
        assert diff.max() <= 3 and (diff > 1).mean() < 0.01, (diff.max(), (diff > 1).mean())
        assert pt.depth.shape == pj.depth.shape and pt.depth.dtype == np.float32
        assert 0.0 <= pt.depth.min() and pt.depth.max() <= 1.0
        np.testing.assert_allclose(pt.depth, pj.depth, atol=5e-3)
