"""The port's RTMP sink (`sinks/rtmp.py`) and web control panel
(`service/control.py`) against the JAX package on the CPU.

- RTMP: the ffmpeg command line equals the JAX sink's for every `audio`
  value, with and without an audio delay and the mediamtx sidecar (fake
  binaries written here, as `tests/test_sources_sinks.py` does), and equals
  the sink's own `ffmpeg_argv`, which the card run checks against; the audio
  probe decides as JAX's on the same host state; the sidecar is reaped, a
  resolution change restarts the encoder, a dead encoder backs off; every
  pushed byte reaches ffmpeg's stdin; the CLI's rtmp kwargs equal JAX's;
- control panel: `parse_model_name`, `build_family_size_map` and
  `worker_stats_from_log` give JAX's results; both panels compose the same
  worker arguments from one form (the tcp source's `tcp:<port>` included);
  the windows endpoint and `X11Capture.list_windows` over a fake native
  library give JAX's lists; the form and its lang guard; and, in the slow
  tier, the real worker subprocess (the port's CLI on the CPU) started with
  POST /start, watched through /status and /logs, and stopped cleanly with
  POST /stop.
"""

import ctypes
import json
import os
import stat
import subprocess
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest

import desktop2stereo_tpu.cli as J_cli
import desktop2stereo_tpu.core.config as J_config
import desktop2stereo_tpu.native as J_native
import desktop2stereo_tpu.service.control as J_control
import desktop2stereo_tpu.sinks.rtmp as J_rtmp
import desktop2stereo_tpu_torch.cli as T_cli
import desktop2stereo_tpu_torch.core.config as T_config
import desktop2stereo_tpu_torch.native as T_native
import desktop2stereo_tpu_torch.service.control as T_control
import desktop2stereo_tpu_torch.sinks.rtmp as T_rtmp
from desktop2stereo_tpu.core.registry import MODEL_REGISTRY as J_REGISTRY
from desktop2stereo_tpu_torch.core.registry import MODEL_REGISTRY as T_REGISTRY
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0
RTMP = {"jax": J_rtmp, "port": T_rtmp}
CONTROL = {"jax": J_control, "port": T_control}


def _fake_bin(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(body)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(p)


@pytest.fixture
def ffmpeg(tmp_path):
    """A fake ffmpeg that counts the bytes on its stdin into `<pid>.bytes`.
    It ignores SIGTERM (the sink terminates it right after closing its
    stdin) from the moment `<pid>.ready` exists."""
    return _fake_bin(tmp_path, "ffmpeg",
                     f"#!/bin/sh\ntrap '' TERM\n: > \"{tmp_path}/$$.ready\"\n"
                     f"wc -c > \"{tmp_path}/$$.bytes.tmp\" && "
                     f'mv "{tmp_path}/$$.bytes.tmp" "{tmp_path}/$$.bytes"\n')


def _wait_file(path):
    deadline = time.monotonic() + WAIT_S
    while not path.exists():
        assert time.monotonic() < deadline, f"{path} never appeared"
        time.sleep(0.01)


@pytest.fixture
def spawned(monkeypatch):
    """Every command line handed to subprocess.Popen (both sinks use the
    one subprocess module)."""
    cmds, real = [], subprocess.Popen

    def spy(cmd, **kw):
        cmds.append(list(cmd))
        return real(cmd, **kw)

    monkeypatch.setattr(subprocess, "Popen", spy)
    return cmds


# ---- RTMP --------------------------------------------------------------------------


@pytest.mark.parametrize("audio,delay", [("none", 0.0), ("none", -0.15), ("mysink.monitor", 0.0),
                                         ("mysink.monitor", -0.15), ("auto", 0.25)])
@pytest.mark.parametrize("url", ["rtmp://127.0.0.1/live/d2s", "srt://127.0.0.1:8890"])
def test_ffmpeg_argv_matches_jax(ffmpeg, spawned, audio, delay, url):
    frame = np.zeros((16, 32, 3), np.uint8)
    sinks = {}
    for pkg in ("jax", "port"):
        sink = sinks[pkg] = RTMP[pkg].RtmpSink(url, ffmpeg=ffmpeg, fps=24.0, crf=18,
                                               audio=audio, audio_delay=delay)
        sink.push(frame, None, {})
        sink.shutdown()
    assert len(spawned) == 2 and spawned[0] == spawned[1]
    assert spawned[1] == sinks["port"].ffmpeg_argv(16, 32)


@pytest.mark.parametrize("mediamtx", [True, False])
def test_sidecar_matches_jax(tmp_path, ffmpeg, spawned, mediamtx):
    """`serve=True` starts the mediamtx sidecar when the binary exists (and
    degrades without it), and shutdown() reaps it."""
    mtx = _fake_bin(tmp_path, "mediamtx", "#!/bin/sh\nexec sleep 60\n") if mediamtx else None
    for pkg in ("jax", "port"):
        sink = RTMP[pkg].RtmpSink("rtmp://127.0.0.1/live/d2s", ffmpeg=ffmpeg, serve=True,
                                  mediamtx=mtx, audio="none")
        server = sink._server
        assert (server is not None and server.poll() is None) == mediamtx
        sink.push(np.zeros((16, 32, 3), np.uint8), None, {})
        sink.shutdown()
        assert sink._server is None and sink._proc is None
        if server is not None:
            assert server.wait(WAIT_S) is not None
    n = len(spawned) // 2
    assert spawned[:n] == spawned[n:]
    assert spawned[:n] == ([[mtx]] if mediamtx else []) + [sink.ffmpeg_argv(16, 32)]


def test_detect_audio_source_matches_jax(tmp_path, monkeypatch):
    for runtime, which in ((tmp_path / "none", None), (tmp_path / "pulse", None),
                           (tmp_path / "none", "/usr/bin/pactl")):
        (tmp_path / "pulse" / "pulse").mkdir(parents=True, exist_ok=True)
        (tmp_path / "pulse" / "pulse" / "native").touch()
        monkeypatch.setenv("XDG_RUNTIME_DIR", str(runtime))
        monkeypatch.setattr(T_rtmp.shutil, "which", lambda name, w=which: w)
        assert T_rtmp.detect_audio_source() == J_rtmp.detect_audio_source()
        if runtime.name == "pulse" or which:
            assert T_rtmp.detect_audio_source() == ["-f", "pulse", "-i", "default"]


def test_every_pushed_byte_reaches_ffmpeg(tmp_path, ffmpeg):
    """The bytes on ffmpeg's stdin are the frames pushed; a resolution change
    restarts the encoder (reference main.py:1018-1061)."""
    sink = T_rtmp.RtmpSink("rtmp://127.0.0.1/live/d2s", ffmpeg=ffmpeg, audio="none")
    frames = [np.full((16, 32, 3), i, np.uint8) for i in range(3)]
    for f in frames:
        sink.push(f, None, {})
    first = sink._proc
    _wait_file(tmp_path / f"{first.pid}.ready")
    sink.push(np.zeros((8, 8, 3), np.uint8), None, {})
    second = sink._proc
    assert second is not first
    _wait_file(tmp_path / f"{second.pid}.ready")
    sink.shutdown()
    for proc, n in ((first, 3 * frames[0].nbytes), (second, 8 * 8 * 3)):
        _wait_file(tmp_path / f"{proc.pid}.bytes")
        assert int((tmp_path / f"{proc.pid}.bytes").read_text()) == n


def test_dead_encoder_backs_off(tmp_path, capsys):
    """An encoder that died (publish URL down) is not respawned every frame:
    the frame is dropped until the backoff ends."""
    dead = _fake_bin(tmp_path, "ffmpeg", "#!/bin/sh\nexit 1\n")
    sink = T_rtmp.RtmpSink("rtmp://127.0.0.1/live/d2s", ffmpeg=dead, audio="none")
    big = np.zeros((512, 512, 3), np.uint8)  # more than a pipe buffer
    deadline = time.monotonic() + WAIT_S
    while sink._fails == 0:
        assert time.monotonic() < deadline
        sink.push(big, None, {})
    assert sink._proc is None and sink._retry_at > time.monotonic() - 1.0
    sink._retry_at = time.monotonic() + WAIT_S
    sink.push(big, None, {})  # inside the backoff: dropped, no new encoder
    assert sink._proc is None
    assert "failing" in capsys.readouterr().out
    sink.shutdown()


def test_missing_ffmpeg_raises(monkeypatch):
    monkeypatch.setattr(T_rtmp.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg binary not found"):
        T_rtmp.RtmpSink("rtmp://127.0.0.1/live")


@pytest.mark.parametrize("argv,extra", [
    ([], {}),
    (["--out", "rtmp://example.org/live/key", "--audio", "none"],
     {"Stream Key": "mine", "CRF": 23, "Audio Delay": -0.2}),
    (["--audio", "dev.monitor"], {"Stream Key": "show"}),
])
def test_rtmp_sink_kwargs_match_jax(argv, extra):
    out = []
    for mod, config in ((T_cli, T_config), (J_cli, J_config)):
        s = config.Settings(fps=50.0)
        s.extra.update(extra)
        out.append(mod._sink_kwargs("rtmp", mod.build_parser().parse_args(argv), s))
    assert out[0] == out[1]


# ---- control panel ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["Depth-Anything-V2-Small", "DepthPro", "DA3-LARGE",
                                  "Video-Depth-Anything-Base", "Foo-Small-Plus", "X-Giant-Large",
                                  "depth-anything-small", "", "Large"])
def test_parse_model_name_matches_jax(name):
    assert T_control.parse_model_name(name) == J_control.parse_model_name(name)


@pytest.mark.parametrize("names", ["port", "jax"])
def test_family_size_map_matches_jax(names):
    registry = sorted(T_REGISTRY if names == "port" else J_REGISTRY)
    assert T_control.build_family_size_map(registry) == J_control.build_family_size_map(registry)
    fams, sizes, full = T_control.build_family_size_map(sorted(T_REGISTRY))
    for fam in fams:
        for size in sizes[fam] or [""]:
            assert full[(fam, size)] in T_REGISTRY


@pytest.mark.parametrize("log", [
    "[d2s] fps=42.5 (1%low=40.1) dropped=3 capture=1.2ms, depth+compose=9.0ms, sink=0.3ms\n",
    "[d2s] warm in 1.0s\n[d2s] fps=12.0 (1%low=11.5) dropped=0 capture=0.5ms "
    "ingest=30.1fps net_dropped=7\n[d2s] fps=13.0 (1%low=12.5) dropped=1 sink=2.0ms\n",
    "[d2s] warming up\n",
    None,
])
def test_worker_stats_from_log_matches_jax(tmp_path, log):
    path = tmp_path / "w.log"
    if log is not None:
        path.write_text(log)
    assert (T_control.worker_stats_from_log(str(path))
            == J_control.worker_stats_from_log(str(path)))


class _Panel:
    """A panel server of either package in a thread, with its worker
    manager replaced by a recorder."""

    def __init__(self, pkg, settings_path, manager=None):
        self.server = CONTROL[pkg].serve(port=0, settings_path=str(settings_path))
        self.calls = []
        if manager is None:
            calls = self.calls

            class Recorder:
                running = False

                def start(self, settings, source, sink, extra_args=None):
                    calls.append((settings.model, settings.depth_resolution, source, sink,
                                  extra_args))

                def stop(self):
                    calls.append("stop")

            manager = Recorder()
        self.server.manager = manager
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever)
        self.thread.start()

    def get(self, path):
        return urllib.request.urlopen(self.url + path, timeout=WAIT_S).read()

    def post(self, path, fields):
        data = urllib.parse.urlencode(fields).encode()
        return urllib.request.urlopen(urllib.request.Request(self.url + path, data=data),
                                      timeout=WAIT_S)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()


FORMS = [
    {"source": "tcp", "ingest_port": "7901", "sink": "null", "model": "Depth-Anything-V2-Small"},
    {"source": "tcp", "sink": "xr,mjpeg", "model": "Depth-Anything-V2-Large",
     "depth_resolution": "518"},
    {"source": "screen", "window_title": "Firefox", "cursor": "off", "monitor": "1",
     "sink": "rtmp", "audio": "none", "quant": "int8", "port": "1935", "model": "DA3-LARGE"},
    {"source": "video", "input": "/tmp/clip.mp4", "sink": "png", "out": "frames",
     "temporal_smooth": "on", "fps": "30", "display_mode": "Mono"},
]


@pytest.mark.parametrize("form", FORMS)
def test_panel_composes_the_worker_arguments_as_jax(tmp_path, monkeypatch, form):
    """The same form posted to both panels starts the worker with the same
    source (`tcp:<ingest port>`, 7800 by default), sink and arguments."""
    monkeypatch.chdir(tmp_path)
    calls = []
    for pkg in ("jax", "port"):
        panel = _Panel(pkg, tmp_path / f"{pkg}.yaml")
        try:
            assert panel.post("/start?lang=zh", form).url.endswith("/?lang=zh")
            panel.post("/stop", {})
        finally:
            panel.close()
        calls.append(panel.calls)
    assert calls[0] == calls[1] and calls[1][-1] == "stop"
    if form["source"] == "tcp":
        assert calls[1][0][2] == "tcp:" + form.get("ingest_port", "7800")


def test_panel_passes_the_device_only_when_not_cuda(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    panel = _Panel("port", tmp_path / "s.yaml")
    try:
        for device in ("cuda", "cpu"):
            panel.post("/start", {"source": "synthetic", "sink": "null", "device": device})
    finally:
        panel.close()
    assert [c[4] for c in panel.calls] == [[], ["--device", "cpu"]]


class _FakeX11:
    TITLES = b"Terminal\nFirefox \xe2\x80\x94 d2s\nTerminal\n\nvlc"

    def __init__(self, display=""):
        self.closed = False

    def list_windows(self):
        return ["Terminal", "Firefox — d2s", "vlc"]

    def close(self):
        self.closed = True


def test_list_windows_binding_matches_jax():
    """X11Capture.list_windows over a fake native call: the titles once each,
    in order, as JAX's binding gives them."""

    class FakeLib:
        def d2s_x11_list_windows(self, handle, buf, cap):
            ctypes.memmove(buf, _FakeX11.TITLES, len(_FakeX11.TITLES))
            return 4

    out = []
    for native in (J_native, T_native):
        cap = native.X11Capture.__new__(native.X11Capture)
        cap._lib, cap._h = FakeLib(), 1
        out.append(cap.list_windows())
    assert out[0] == out[1] == _FakeX11().list_windows()


def test_windows_endpoint_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = {}
    for pkg, native in (("jax", J_native), ("port", T_native)):
        monkeypatch.setattr(native, "X11Capture", _FakeX11)
        panel = _Panel(pkg, tmp_path / f"{pkg}.yaml")
        try:
            got[pkg] = json.loads(panel.get("/windows"))
            status = json.loads(panel.get("/status"))
        finally:
            panel.close()
        assert status == {"running": False, "pid": None, "stats": {}}
    assert got["port"] == got["jax"] == _FakeX11().list_windows()


def test_windows_endpoint_without_a_display(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    panel = _Panel("port", tmp_path / "s.yaml")
    try:
        assert json.loads(panel.get("/windows")) == []
    finally:
        panel.close()


def test_form_lists_the_port_registry_and_guards_lang(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    page = T_control._form_page(T_config.Settings(), "en").decode()
    for frag in ('id="family"', 'id="msize"', "row_monitor", "row_window", "row_audio",
                 "row_ingest", "<option>tcp</option>", "<option>xr,mjpeg</option>",
                 "syncRows()", "refreshWindows", 'id="stats"', 'name="device"',
                 '<option value="cuda">CUDA</option>', "temporal_smooth", "Depth Model"):
        assert frag in page, frag
    fams, _, _ = T_control.build_family_size_map(sorted(T_REGISTRY))
    for fam in fams:
        assert f">{fam}</option>" in page, fam
    assert "深度模型" in T_control._form_page(T_config.Settings(), "zh").decode()
    evil = T_control._form_page(T_config.Settings(), lang='"><script>alert(1)</script>')
    assert b"<script>alert" not in evil and b'action="/start?lang=en"' in evil
    panel = _Panel("port", tmp_path / "s.yaml")
    try:
        assert b"Depth Model" in panel.get("/?lang=en")
        assert panel.get("/logs") == b""
    finally:
        panel.close()


@pytest.mark.slow
def test_panel_runs_and_stops_the_real_worker(tmp_path, monkeypatch):
    """POST /start spawns the port's CLI (the CPU path, a small model), the
    panel's /status shows its stats line and /logs its output, and POST
    /stop ends it through the stop file with exit code 0.  Slow: a fresh
    interpreter imports torch and runs a model on the CPU for a few stats
    periods."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    server = T_control.serve(port=0, settings_path=str(tmp_path / "settings.yaml"))
    panel = _Panel.__new__(_Panel)
    panel.server, panel.calls = server, []
    panel.url = f"http://127.0.0.1:{server.server_address[1]}"
    panel.thread = threading.Thread(target=server.serve_forever)
    panel.thread.start()
    manager = server.manager
    try:
        panel.post("/start", {"source": "synthetic", "sink": "null", "device": "cpu",
                              "model": "Depth-Anything-V2-Small", "depth_resolution": "56",
                              "output_resolution": "112", "fps": "30"})
        assert manager.running
        deadline = time.monotonic() + 240.0
        status = {}
        while not status.get("stats", {}).get("fps"):
            assert time.monotonic() < deadline, panel.get("/logs").decode()
            assert manager.running, panel.get("/logs").decode()
            time.sleep(0.5)
            status = json.loads(panel.get("/status"))
        assert status["running"] and status["pid"] == manager.proc.pid
        assert b"[d2s] device: cpu" in panel.get("/logs")
        panel.post("/stop", {})
        assert manager.proc.wait(WAIT_S) == 0
        assert b"stop.request received" in panel.get("/logs")
        assert json.loads(panel.get("/status"))["running"] is False
    finally:
        if manager.running:
            manager.proc.kill()
            manager.proc.wait(WAIT_S)
        panel.close()
