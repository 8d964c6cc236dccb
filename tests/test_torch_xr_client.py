"""The port's workstation XR client against the JAX client on the CPU.

The warp: the client's half-pixel bilinear depth upsample, `warp_eye` on
both eyes with and without a roll (atol 1e-2, rtol 1e-4, as the JAX suite
holds its numpy warp to `ops/stereo.dibr_render`), and `render_stereo`'s
Full-SBS, Half-SBS and odd-width Half-SBS frames in uint8.  The roll-0 warp
goes through the K5 wrapper (`ops.kernels.dibr_fill`, its plain version on
a CPU tensor) once an eye, a roll through none.  Then the entry points:
`main` with the self-test source and the png presenter, flat and with the
CPU-rasterized theater, against the JAX client's PNGs; the port's client
against the port's CLI serving `--sink xr` over loopback; and `--device
cuda` on a host without a card, which exits naming CUDA.
"""

import argparse
import math
import os
import threading

import numpy as np
import pytest
import torch

import desktop2stereo_tpu.tools.xr_client as JC
import desktop2stereo_tpu_torch.ops.stereo as T_stereo
import desktop2stereo_tpu_torch.tools.xr_client as TC
from torch_threads import one_torch_thread  # noqa: F401
from torch_xr_common import assert_same, u8_share

H, W = 48, 96
WAIT_S = 60.0


class _CountK5:
    """The K5 wrapper as `ops.stereo` calls it, counted."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.fixture
def k5(monkeypatch):
    counted = _CountK5(T_stereo.dibr_warp_fill_blend)
    monkeypatch.setattr(T_stereo, "dibr_warp_fill_blend", counted)
    return counted


def _inputs(seed, w=W, depth_kind="model"):
    rng = np.random.default_rng(seed)
    rgb = (rng.random((H, w, 3)) * 255).astype(np.uint8)
    if depth_kind == "full":
        depth = rng.random((H, w)).astype(np.float32)
    elif depth_kind == "model":
        depth = rng.random((24, 42)).astype(np.float32)
    else:  # a smooth scene with one near object, at model resolution
        yy, xx = np.mgrid[0:24, 0:42] / np.array([24.0, 42.0])[:, None, None]
        depth = (0.2 + 0.6 * xx + 0.3 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.05)
                 ).astype(np.float32)
    return rgb, depth


@pytest.mark.parametrize("shape", [(24, 42), (294, 518), (48, 96), (60, 100)])
def test_resize_bilinear_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.random(shape).astype(np.float32)
    got = TC._resize_bilinear(torch.from_numpy(img), H, W)
    assert got.dtype == torch.float32 and tuple(got.shape) == (H, W)
    np.testing.assert_allclose(got.numpy(), JC._resize_bilinear(img, H, W), atol=1e-6, rtol=0)


@pytest.mark.parametrize("depth_kind", ["full", "model"])
@pytest.mark.parametrize("roll", [0.0, 0.3, -1.1, math.pi])
def test_warp_eye_matches_jax(roll, depth_kind, k5):
    rgb, depth = _inputs(7, depth_kind=depth_kind)
    rgb = rgb.astype(np.float32)
    for eye in (-0.032, +0.032):
        got = TC.warp_eye(torch.from_numpy(rgb), torch.from_numpy(depth), eye,
                          depth_strength=2.0, convergence=0.01, roll=roll)
        assert got.dtype == torch.float32 and tuple(got.shape) == (H, W, 3)
        want = JC.warp_eye(rgb, depth, eye, depth_strength=2.0, convergence=0.01, roll=roll)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=1e-4)
    # roll 0 goes through the K5 wrapper once an eye; a roll (π too) never
    assert k5.calls == (2 if roll == 0.0 else 0)


def _jax_float_sbs(rgb_u8, depth, mode, roll=0.0):
    """JAX's render_stereo before its rounding (its own eyes and arrangement)."""
    rgb = rgb_u8.astype(np.float32)
    left = JC.warp_eye(rgb, depth, -0.032, 2.0, 0.01, roll=roll)
    right = JC.warp_eye(rgb, depth, +0.032, 2.0, 0.01, roll=roll)
    if mode == "Half-SBS":
        if left.shape[1] % 2:
            left, right = left[:, :-1], right[:, :-1]
        left = (left[:, 0::2] + left[:, 1::2]) * 0.5
        right = (right[:, 0::2] + right[:, 1::2]) * 0.5
    return np.concatenate([left, right], axis=1)


@pytest.mark.parametrize("depth_kind", ["scene", "model", "full"])
@pytest.mark.parametrize("mode,w", [("Full-SBS", W), ("Half-SBS", W), ("Half-SBS", 95)])
def test_render_stereo_matches_jax(mode, w, depth_kind, k5):
    """uint8 frames within 1 LSB of the JAX client's, and off only where the
    value sits on a rounding tie.

    The client rounds by +0.5 and truncation.  The vertical blend's quarter
    weights put many values at exactly k + 0.5 on noise content (the share
    grows with the disocclusions); the port rounds those in float32, while
    the JAX client's upsample promotes a model-resolution depth to float64
    (`ys - y0`: float32 minus int64) and its sweep weights are float64, so
    it lands a hair either side.  A value of the JAX frame's float within
    2e-3 of a tie may round either way; every other value must be equal.
    2e-3 is twice the largest float difference of the two warps here."""
    rgb, depth = _inputs(11, w, depth_kind)
    got = TC.render_stereo(rgb, depth, 0.064, 2.0, 0.01, mode=mode, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    want = JC.render_stereo(rgb, depth, 0.064, 2.0, 0.01, mode=mode)
    got = got.numpy()
    assert got.shape == want.shape == (H, 2 * w if mode == "Full-SBS" else w - w % 2, 3)
    f = _jax_float_sbs(rgb, depth, mode)
    np.testing.assert_array_equal(np.clip(f + 0.5, 0, 255).astype(np.uint8), want)
    tie = np.abs((f + 0.5) - np.round(f + 0.5)) < 2e-3
    lsb, share = u8_share(got, want)
    assert lsb <= 1, (lsb, share)
    np.testing.assert_array_equal(got[~tie], want[~tie])
    assert k5.calls == 2


@pytest.mark.parametrize("mode,w", [("Full-SBS", W), ("Half-SBS", W), ("Half-SBS", 95)])
def test_render_stereo_without_depth_matches_jax_exactly(mode, w):
    rgb, _ = _inputs(12, w)
    got = TC.render_stereo(rgb, None, 0.064, 2.0, 0.01, mode=mode, device="cpu")
    np.testing.assert_array_equal(got.numpy(), JC.render_stereo(rgb, None, 0.064, 2.0, 0.01,
                                                                mode=mode))


def test_render_stereo_with_a_roll_takes_no_kernel(k5):
    rgb, depth = _inputs(13, depth_kind="scene")
    got = TC.render_stereo(rgb, depth, 0.064, 2.0, 0.01, roll=0.2, device="cpu")
    want = JC.render_stereo(rgb, depth, 0.064, 2.0, 0.01, roll=0.2)
    assert k5.calls == 0
    f = _jax_float_sbs(rgb, depth, "Full-SBS", roll=0.2)
    tie = np.abs((f + 0.5) - np.round(f + 0.5)) < 2e-3
    assert u8_share(got.numpy(), want)[0] <= 1
    np.testing.assert_array_equal(got.numpy()[~tie], want[~tie])


def test_render_stereo_takes_tensors_and_numpy_alike():
    rgb, depth = _inputs(14)
    a = TC.render_stereo(rgb, depth, 0.064, 2.0, 0.01, device="cpu")
    b = TC.render_stereo(torch.from_numpy(rgb), torch.from_numpy(depth), 0.064, 2.0, 0.01,
                         device=torch.device("cpu"))
    ro = rgb.copy()
    ro.flags.writeable = False  # a frame as the network hands it
    c = TC.render_stereo(ro, depth, 0.064, 2.0, 0.01, device="cpu")
    assert torch.equal(a, b) and torch.equal(a, c)


def test_client_helpers_match_jax():
    quats = [(0, 0, 0, 1), (0.0, 0.0, math.sin(math.pi / 4), math.cos(math.pi / 4)),
             (0.1, 0.2, 0.3, 0.93), (0.5, -0.5, 0.5, 0.5)]
    out = {}
    for pkg, XC in (("jax", JC), ("port", TC)):
        args = argparse.Namespace(ipd=None, depth_strength=3.0, convergence=None)
        XC.adopt_server_meta(args, {"ipd": 0.07, "convergence": None})
        args2 = argparse.Namespace(ipd=None, depth_strength=None, convergence=None)
        XC.adopt_server_meta(args2, {})
        src = XC.SelfTestSource(size=(32, 16), fps=0.0)
        pkts = [src.poll(), src.poll()]
        v = XC.XrView()
        th_args = argparse.Namespace(theater="auto", env=None, lang="CN", vendor="pico")
        th = XC.build_theater(th_args)
        out[pkg] = [[XC.head_roll(q) for q in quats], [XC._quat_forward(q) for q in quats],
                    vars(args), vars(args2), [(p.rgb, p.depth, p.seq) for p in pkts],
                    (v.orientation, v.position, v.fov),
                    [XC.theater_enabled(argparse.Namespace(theater=m), k)
                     for m in ("auto", "on", "off") for k in ("png", "cv", "glfw", "openxr")],
                    th.vendor, th.lang, XC._DIBR_FRAG, XC._THEATER_KEYS,
                    XC._fullscreen_screen_item({"eye_offset": 0.1}).__dict__]
    assert_same(out["port"], out["jax"])


def test_parser_is_the_jax_clients_plus_device():
    t, j = TC.build_parser(), JC.build_parser()
    tf = {a.dest: a for a in t._actions}
    jf = {a.dest: a for a in j._actions}
    assert set(tf) == set(jf) | {"device"}
    for dest, ja in jf.items():
        ta = tf[dest]
        assert (ta.option_strings, ta.default, ta.choices, ta.nargs, ta.type) == (
            ja.option_strings, ja.default, ja.choices, ja.nargs, ja.type), dest
    dev = tf["device"]
    assert dev.default == "cuda" and set(dev.choices) == {"cuda", "cpu", "auto"}


def test_auto_presenter_falls_back_like_jax(tmp_path, monkeypatch):
    """--present auto tries glfw, then cv, then png; on this headless host
    both clients end at the png presenter."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    kinds = []
    for XC in (JC, TC):
        args = XC.build_parser().parse_args(["--out", str(tmp_path / XC.__name__),
                                             "--present", "auto"])
        p = XC.make_presenter("auto", args)
        kinds.append(type(p).__name__)
        p.close()
    assert kinds == ["PngPresenter", "PngPresenter"]


def _pngs(path):
    from PIL import Image

    return [np.asarray(Image.open(p)) for p in sorted(path.glob("frame_*.png"))]


@pytest.mark.parametrize("extra", [
    ["--theater", "off"],
    ["--theater", "on", "--theater-size", "192", "108", "--show-glow", "--show-keyboard",
     "--mode", "Half-SBS"],
    ["--theater", "on", "--theater-size", "160", "90", "--show-help-panel", "--env", "absent"],
])
def test_selftest_png_matches_jax(tmp_path, extra, k5):
    """`main --test --present png`: the white 1280x720 frame with zero depth
    (zero parallax), flat and in the theater, PNG for PNG within 1 LSB of
    the JAX client's; the port's warp ran K5's wrapper once an eye."""
    argv = ["--test", "--present", "png", "--frames", "1", "--ipd", "0.064",
            "--depth-strength", "2.0", "--convergence", "0.01"] + extra
    assert JC.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert TC.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert u8_share(g, w)[0] <= 1
    if extra[1] == "off":
        assert got[0].shape == (720, 2560, 3) and got[0].min() == 255
    elif "--show-help-panel" not in extra:
        h, w2 = got[0].shape[0], got[0].shape[1] // 2
        assert got[0][h // 2, w2 // 2].min() > 180  # the white screen
    assert k5.calls == 2


def test_device_cuda_without_a_card_exits_naming_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(SystemExit) as e:
        TC.main(["--test", "--present", "png", "--frames", "1", "--out", str(tmp_path)])
    assert e.value.code == 2
    assert "CUDA" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.png"))  # nothing ran on the CPU instead


def test_client_against_the_port_cli_over_loopback(tmp_path, monkeypatch, k5):
    """The port's CLI serves a tiny DA-V2 with `--sink xr --port 0` in a
    thread; the port's client polls it on the CPU and writes Full-SBS PNGs
    of twice the served frame's width."""
    import jax
    import jax.numpy as jnp

    import desktop2stereo_tpu_torch.cli as T_cli
    import desktop2stereo_tpu_torch.models.factory as T_factory
    import desktop2stereo_tpu_torch.sinks as T_sinks
    from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
    from desktop2stereo_tpu_torch.core.registry import ModelSpec
    from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
    from desktop2stereo_tpu_torch.models.from_flax import from_flax
    from test_torch_cli import SPEC, TINY, _seeded_params

    params = _seeded_params(JDepthAnything(**TINY), jnp.zeros((1, 28, 42, 3), jnp.float32))
    model = DepthAnything(**TINY).eval()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)), strict=True)
    monkeypatch.setattr(T_factory, "build_bound", lambda name, **kw: (model, ModelSpec(**SPEC)))
    made, ready = {}, threading.Event()
    make_sink = T_sinks.make_sink

    def rec_sink(kind, **kw):
        made["sink"] = make_sink(kind, **kw)
        ready.set()
        return made["sink"]

    monkeypatch.setattr(T_sinks, "make_sink", rec_sink)
    monkeypatch.chdir(tmp_path)
    stop = tmp_path / "stop.request"
    rc = {}

    def serve():
        rc["server"] = T_cli.run([
            "--source", "synthetic", "--size", "72x128", "--sink", "xr", "--port", "0",
            "--xr-no-input", "--model", "Depth-Anything-V2-Small", "--depth-res", "56",
            "--display-mode", "Mono", "--fp32", "--duration", "120", "--stop-file",
            str(stop), "--stats-every", "0", "--device", "cpu"])

    t = threading.Thread(target=serve)
    t.start()
    try:
        assert ready.wait(WAIT_S)
        out = tmp_path / "frames"
        assert TC.main(["--port", str(made["sink"].port), "--present", "png", "--out",
                        str(out), "--frames", "3", "--poll-timeout", "2.0",
                        "--device", "cpu"]) == 0
    finally:
        stop.touch()
        t.join(WAIT_S)
    assert not t.is_alive() and rc["server"] == 0
    frames = _pngs(out)
    assert len(frames) == 3
    for f in frames:
        assert f.shape == (72, 256, 3) and f.dtype == np.uint8
    left, right = frames[-1][:, :128].astype(int), frames[-1][:, 128:].astype(int)
    assert np.abs(left - right).mean() > 0.1  # the client's warp made parallax
    assert k5.calls == 6
    assert os.path.isdir(out)
