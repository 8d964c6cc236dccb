"""The port's CLI (`python -m desktop2stereo_tpu_torch.cli`) against the JAX
package's on the CPU.

- the flags the two CLIs share have the same dest, default and choices
  (`--device` takes cuda/cpu/auto in the port);
- `apply_settings_defaults` and `_sink_for_run_mode` resolve as JAX's;
- every option the port does not have yet exits naming its ROADMAP item;
- the remote topology's options run: `--source tcp[:PORT]` fed over
  loopback, `--sink rtmp` into a fake ffmpeg, `--sink xr` alone and in a tee
  (each port bound free and read back), and a tcp port out of range exits;
- `--device cpu` runs a small synthetic frame path to the end in a fresh
  interpreter, and without `--device` (CUDA, absent here) the CLI exits
  non-zero naming CUDA, with no CPU fallback;
- end to end: both CLIs' `run()` on one settings file, a 3-frame synthetic
  source and the png sink, with one tiny Depth-Anything's weights (the JAX
  tree, and `from_flax` of it).  The JAX side takes its TPU dispatch, its
  DIBR kernel in interpret mode behind a counter, as
  `tests/test_torch_pipeline.py` does.  The PNGs agree within that file's
  tolerances for the fused branch: SBS at most 3 LSB and under 1% of values
  more than 1 LSB off; depth within 5e-3, which the u8 depth PNG turns into
  at most 2 LSB.
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.cli as J_cli
import desktop2stereo_tpu.core.config as J_config
import desktop2stereo_tpu.core.runtime as J_runtime
import desktop2stereo_tpu.models.factory as J_factory
import desktop2stereo_tpu.ops.pallas.dibr as J_dibr
import desktop2stereo_tpu.ops.stereo as J_stereo
import desktop2stereo_tpu.pipeline.programs as J_programs
import desktop2stereo_tpu.sources as J_sources
import desktop2stereo_tpu.sources.synthetic as J_synthetic
import desktop2stereo_tpu_torch.cli as T_cli
import desktop2stereo_tpu_torch.core.config as T_config
import desktop2stereo_tpu_torch.models.factory as T_factory
import desktop2stereo_tpu_torch.sources as T_sources
import desktop2stereo_tpu_torch.sources.synthetic as T_synthetic
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=64, num_layers=4, num_heads=2, mlp_dim=128,
            out_layers=(0, 1, 2, 3), neck_channels=(16, 32, 64, 64), fusion_channels=32)
SPEC = dict(name="tiny", family="depth_anything", variant="vits", hf_repo="none")


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_shared_flags_match_jax():
    t, j = _flags(T_cli.build_parser()), _flags(J_cli.build_parser())
    assert set(t) == set(j)
    for dest, ja in j.items():
        ta = t[dest]
        assert ta.option_strings == ja.option_strings, dest
        assert type(ta) is type(ja) and ta.type == ja.type, dest
        if dest == "device":
            assert (ta.default, ta.choices) == ("cuda", ["cuda", "cpu", "auto"])
            continue
        assert (ta.default, ta.choices) == (ja.default, ja.choices), dest


_SCENARIOS = [
    ([], {}, {}),
    (["--settings", "x.yaml"], {"run_mode": "OpenXR Link"},
     {"Capture Mode": "Window", "Window Title": "vlc", "Monitor Index": 1, "Crop Mode": "Auto"}),
    (["--settings", "x.yaml", "--source", "synthetic", "--sink", "png", "--crop", "off",
      "--monitor", "0", "--window-title", "other"], {"run_mode": "RTMP Streamer"},
     {"Capture Mode": "Window", "Window Title": "vlc", "Crop Mode": "auto", "Monitor Index": 2}),
    (["--settings", "x.yaml"], {}, {"Monitor Index": "none"}),
    (["--settings", "x.yaml"], {"run_mode": "OpenXR Link"}, {"XR Preview": True}),
    (["--settings", "x.yaml", "--sink", "xr"], {"run_mode": "OpenXR Link"}, {"XR Preview": True}),
    (["--settings", "x.yaml"], {"run_mode": "MJPEG Streamer"},
     {"Capture Mode": "Window", "Window Title": "  ", "Monitor Index": True}),
    (["--source", "shm", "--crop", "0,0.1,1,0.8"], {"run_mode": "Local Viewer"}, {}),
]


@pytest.mark.parametrize("display", [None, ":0"])
@pytest.mark.parametrize("argv,fields,extra", _SCENARIOS)
def test_apply_settings_defaults_matches_jax(monkeypatch, display, argv, fields, extra):
    if display:
        monkeypatch.setenv("DISPLAY", display)
    else:
        monkeypatch.delenv("DISPLAY", raising=False)
    out = []
    for mod, config in ((T_cli, T_config), (J_cli, J_config)):
        settings = config.Settings(**fields)
        settings.extra.update(extra)
        args = mod.build_parser().parse_args(argv)
        mod.apply_settings_defaults(args, settings)
        out.append({k: getattr(args, k, None) for k in (
            "source", "source_from_settings", "sink", "crop", "monitor", "window_title")})
    assert out[0] == out[1]


def test_unknown_source_is_rejected_before_the_model_build():
    args = T_cli.build_parser().parse_args(["--source", "webcam"])
    with pytest.raises(SystemExit, match="unknown --source"):
        T_cli.apply_settings_defaults(args, T_config.Settings())


@pytest.mark.parametrize("display", [None, ":0"])
def test_sink_for_run_mode_matches_jax(monkeypatch, display):
    if display:
        monkeypatch.setenv("DISPLAY", display)
    else:
        monkeypatch.delenv("DISPLAY", raising=False)
    for rm in ("Local Viewer", "3D Monitor", "Viewer", "RTMP Streamer", "OpenXR Link",
               "OpenXR", "MJPEG Streamer", "Streamer", "", None, " Local Viewer "):
        assert T_cli._sink_for_run_mode(rm) == J_cli._sink_for_run_mode(rm), rm


@pytest.fixture
def tiny_build(monkeypatch):
    """The port's build_bound patched to a tiny random model on the CPU;
    records its calls."""
    calls = []

    def build(name, device=None, dtype=None, seed=0, quant="none", checkpoint=None):
        calls.append((name, str(device), dtype, quant))
        return (T_factory.init_random(DepthAnything(**TINY), seed).eval(), TSpec(**SPEC))

    monkeypatch.setattr(T_factory, "build_bound", build)
    return calls


@pytest.mark.parametrize("argv,item", [
    (["--streams", "2"], "A6"),
    (["--batched"], "A6"),
    (["--profile-dir", "trace"], "A10"),
], ids=["streams", "batched", "profile_dir"])
def test_unported_options_exit_naming_their_roadmap_item(tmp_path, monkeypatch, tiny_build,
                                                         argv, item):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=item):
        T_cli.run(argv + ["--size", "64x112", "--frames", "1"])


@pytest.mark.parametrize("argv,port", [
    (["--source", "tcp:0", "--sink", "null"], 0),
    (["--source", "tcp", "--sink", "null"], 7800),
    (["--source", "synthetic", "--sink", "rtmp", "--out", "rtmp://127.0.0.1/live/t"], None),
    (["--source", "synthetic", "--sink", "xr", "--port", "0", "--xr-no-input"], 0),
    (["--source", "synthetic", "--sink", "null,xr", "--port", "0", "--xr-no-input"], 1123),
], ids=["tcp_port", "tcp", "rtmp", "xr", "tee_xr"])
def test_remote_options_run(tmp_path, monkeypatch, tiny_build, argv, port):
    """Each option of the remote topology runs one frame to the end on the
    CPU.  The tcp source is fed over loopback; a default port (7800 for
    tcp, 1123 for an xr sink that --port does not steer) is checked as
    asked for and then bound free."""
    import stat
    import threading

    import desktop2stereo_tpu_torch.sinks as T_sinks
    from desktop2stereo_tpu_torch.sources.net import TcpFrameSender

    monkeypatch.chdir(tmp_path)
    ffmpeg = tmp_path / "bin" / "ffmpeg"
    ffmpeg.parent.mkdir()
    ffmpeg.write_text(f"#!/bin/sh\nwc -c > {tmp_path}/ffmpeg.bytes\n")
    ffmpeg.chmod(ffmpeg.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{ffmpeg.parent}{os.pathsep}{os.environ['PATH']}")
    made, ready = {}, threading.Event()
    make_source, make_sink = T_sources.make_source, T_sinks.make_sink

    def rec_source(kind, **kw):
        if kind == "tcp":
            assert kw["port"] == port and kw["timeout"] == 30.0 and kw["max_frames"] == 1
            kw["port"] = 0
        made["source"] = make_source(kind, **kw)
        ready.set()
        return made["source"]

    def rec_sink(kind, **kw):
        if kind == "xr":
            assert kw["port"] == port
            kw["port"] = 0
        made[kind] = make_sink(kind, **kw)
        return made[kind]

    monkeypatch.setattr(T_sources, "make_source", rec_source)
    monkeypatch.setattr(T_sinks, "make_sink", rec_sink)
    stop = threading.Event()

    def agent():  # a capture agent streaming until the run ends
        assert ready.wait(60)
        snd = TcpFrameSender("127.0.0.1", made["source"].port)
        try:
            while not stop.is_set():
                snd.send(np.zeros((64, 112, 4), np.uint8))
                time.sleep(0.01)
        except OSError:
            pass  # the source closed at the end of the run
        finally:
            snd.close()

    t = threading.Thread(target=agent)
    if "tcp" in argv[1]:
        t.start()
    try:
        rc = T_cli.run(argv + ["--device", "cpu", "--size", "64x112", "--frames", "1",
                               "--stats-every", "0"])
    finally:
        stop.set()
        if t.is_alive():
            t.join(60)
    assert rc == 0 and not t.is_alive()
    if "tcp" in argv[1]:
        st = made["source"].stats()
        assert st["frames_delivered"] == 1 and st["frames_received"] >= 1
    if "xr" in made:
        assert made["xr"].frames.frames_served >= 1
        assert made["xr"].frames.latest().depth is not None  # the xr sink takes depth
    if "rtmp" in argv[3]:
        deadline = time.monotonic() + 60
        while not (tmp_path / "ffmpeg.bytes").exists():
            assert time.monotonic() < deadline
            time.sleep(0.01)


def test_tcp_port_out_of_range_exits(tmp_path, monkeypatch, tiny_build):
    monkeypatch.chdir(tmp_path)
    for source in ("tcp:70000", "tcp:x"):
        with pytest.raises(SystemExit, match="expected tcp:<port 0-65535>"):
            T_cli.run(["--device", "cpu", "--source", source, "--sink", "null"])


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_no_cuda_exits_without_a_cpu_fallback(tmp_path, monkeypatch, capsys, tiny_build, device):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        T_cli.run(["--device", device, "--source", "synthetic", "--sink", "null"])
    assert e.value.code == 2 and "CUDA" in capsys.readouterr().err
    assert tiny_build == []  # no model was built


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable, "-m", "desktop2stereo_tpu_torch.cli", *args,
                           "--stop-file", str(tmp_path / "stop.request")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_cpu_run_in_a_fresh_interpreter(tmp_path):
    proc = _cli(["--device", "cpu", "--source", "synthetic", "--size", "64x112", "--frames",
                 "2", "--sink", "null", "--model", "Depth-Anything-V2-Small", "--depth-res",
                 "56"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "device: cpu" in proc.stdout and "[d2s] done:" in proc.stdout


def test_default_device_needs_cuda(tmp_path):
    proc = _cli(["--source", "synthetic", "--size", "64x112", "--frames", "2", "--sink",
                 "null", "--model", "Depth-Anything-V2-Small", "--depth-res", "56"], tmp_path)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "device: cpu" not in proc.stdout


# ---- end to end against the JAX CLI ----------------------------------------------------

FRAME = (360, 640)  # a capture the processing resolution halves to 180x320
OUT = (180, 320)
SETTINGS = {"Depth Model": "Depth-Anything-V2-Small", "Depth Resolution": 126,
            "Processing Resolution": 180, "Display Mode": "Half-SBS", "IPD": 0.064,
            "Depth Strength": 2.0, "Convergence": 0.01, "Foreground Scale": 0,
            "Anti-aliasing": 1.0, "Temporal Smooth": True, "Set FPS": 1000.0,
            "Run Mode": "MJPEG Streamer", "Language": "EN"}


def _seeded_params(module, sample, seed=0):
    """Flax parameters drawn with numpy from a seed (as in
    tests/test_torch_pipeline.py): fan-in scaled normal kernels, unit norm and
    layer scales, small normal biases and embeddings."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), sample))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale" or name.startswith("layer_scale"):
            return np.ones(leaf.shape, np.float32)
        std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if name == "kernel" else 0.02
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _paced(cls, out_dir):
    """A 3-frame synthetic source that hands out a frame only once the png
    sink has begun writing the one before, so neither engine supersedes a
    frame (latest-wins would give the two runs' EMAs different frames)."""

    class Paced(cls):
        def grab(self):
            if 0 < self._i < 3:
                last = out_dir / f"sbs_{self._i - 1:06d}.png"
                deadline = time.monotonic() + 120.0
                while not last.exists():
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{last} was not written")
                    time.sleep(0.01)
            return super().grab()

    return lambda kind, **kw: Paced(size=FRAME, max_frames=3)


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        out = self.fn(*args, **dict(kw, interpret=True))
        self.calls += 1
        return out


def _run_keeping_signals(run, argv):
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        return run(argv)
    finally:
        for s, h in saved.items():
            signal.signal(s, h)


def test_cli_end_to_end_matches_jax(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    settings = tmp_path / "settings.yaml"
    T_config.update_yaml(settings, SETTINGS)
    params = _seeded_params(JDepthAnything(**TINY), jnp.zeros((1, 28, 42, 3), jnp.float32))
    model = DepthAnything(**TINY).eval()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)), strict=True)

    # the JAX CLI: its TPU dispatch with the DIBR pair kernel in interpret mode
    counted = _Counted(J_dibr.dibr_render_pair_planar)
    monkeypatch.setattr(J_dibr, "dibr_render_pair_planar", counted)
    monkeypatch.setattr(J_programs, "_stereo_on_tpu", lambda: True)
    monkeypatch.setattr(J_stereo, "_on_tpu", lambda: True)
    monkeypatch.setattr(J_cli, "_apply_device_choice", lambda device: None)
    monkeypatch.setattr(J_runtime, "setup_compilation_cache", lambda *a: "")
    monkeypatch.setattr(J_factory, "build_bound", lambda name, **kw: (
        J_programs.BoundModel.stateless(JDepthAnything(**TINY).apply, params), JSpec(**SPEC)))
    monkeypatch.setattr(J_sources, "make_source",
                        _paced(J_synthetic.SyntheticSource, tmp_path / "jax"))
    # the port's CLI: the same weights, on the CPU
    monkeypatch.setattr(T_factory, "build_bound", lambda name, **kw: (model, TSpec(**SPEC)))
    monkeypatch.setattr(T_sources, "make_source",
                        _paced(T_synthetic.SyntheticSource, tmp_path / "port"))

    common = ["--settings", str(settings), "--source", "synthetic", "--sink", "png",
              "--fp32", "--stats-every", "0"]
    assert _run_keeping_signals(J_cli.run, common + ["--device", "cpu", "--out", "jax"]) == 0
    assert counted.calls > 0
    assert _run_keeping_signals(T_cli.run, common + ["--device", "cpu", "--out", "port"]) == 0

    names = sorted(os.listdir(tmp_path / "jax"))
    # the frames differ (the synthetic scene moves), so the EMA carry matters
    sbs = [np.asarray(Image.open(tmp_path / "jax" / f"sbs_{i:06d}.png")) for i in range(3)]
    assert not np.array_equal(sbs[0], sbs[1]) and not np.array_equal(sbs[1], sbs[2])
    assert names == [f"{k}_{i:06d}.png" for k in ("depth", "sbs") for i in range(3)]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        j = np.asarray(Image.open(tmp_path / "jax" / name)).astype(np.int32)
        t = np.asarray(Image.open(tmp_path / "port" / name)).astype(np.int32)
        assert t.shape == j.shape == ((*OUT, 3) if name.startswith("sbs") else OUT), name
        diff = np.abs(t - j)
        if name.startswith("sbs"):
            assert diff.max() <= 3, (name, diff.max())
            assert (diff > 1).mean() < 0.01, (name, (diff > 1).mean())
        else:
            assert diff.max() <= 2, (name, diff.max())
