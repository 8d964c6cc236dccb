"""The whole slice: the port's ProgramCache and FrameEngine against the JAX
package's fused Half-SBS / Half-TAB branch, on the CPU in f32.

On the CPU the JAX ProgramCache takes its generic tail, which warps at full
width and squeezes after; the flagship path (and the port) squeezes first
and warps at eye width.  So the JAX side is forced onto its fused branch
here: `programs._stereo_on_tpu` returns True and the DIBR pair kernel runs
in Pallas interpret mode.  Both sides run the same tiny Depth-Anything with
the same weights (JAX init, moved over with `from_flax`) over three frames,
so the EMA carry is exercised.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.ops.pallas.dibr as J_dibr
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu.models.init_util import jit_init
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine

TINY = dict(hidden_size=64, num_layers=4, num_heads=2, mlp_dim=128,
            out_layers=(0, 1, 2, 3), neck_channels=(16, 32, 64, 64),
            fusion_channels=32)
SPEC = dict(name="tiny", family="depth_anything", variant="vits", hf_repo="none")
CFG = dict(model_name="tiny", depth_resolution=126, output_height=180,
           ipd=0.064, depth_strength=2.0, convergence=0.01, foreground_scale=0.0,
           aa_strength=2.0, ema_alpha=0.9, temporal_smooth=True, quality="high")


def _frames(n=3, h=180, w=320):
    """A smooth scene with moving content and noise, BGRA u8."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for t in range(n):
        base = 128 + 90 * np.sin((xx + 9 * t) / 23.0)[..., None] * np.cos(yy / 17.0)[..., None]
        rgb = base + np.array([0.0, 30.0, -30.0]) + 12 * rng.standard_normal((h, w, 3))
        bgra = np.concatenate([np.clip(rgb, 0, 255)[..., ::-1],
                               np.full((h, w, 1), 255.0)], axis=-1)
        out.append(bgra.astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def tiny():
    params = jit_init(JDepthAnything(**TINY), jnp.zeros((1, 28, 42, 3), jnp.float32),
                      rng_seed=0)
    model = DepthAnything(**TINY).eval()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return params, model


def _port_cache(model, mode, emit):
    cfg = T_programs.ProgramConfig(display_mode=mode, emit_depth=emit, **CFG)
    return T_programs.ProgramCache(cfg, model, TSpec(**SPEC), compute_dtype=torch.float32)


@pytest.mark.parametrize("mode,emit", [("Half-SBS", "model"), ("Half-TAB", "full")])
def test_slice_matches_jax_fused_branch(tiny, monkeypatch, mode, emit):
    params, model = tiny
    monkeypatch.setattr(J_programs, "_stereo_on_tpu", lambda: True)
    monkeypatch.setattr(J_dibr, "dibr_render_pair_planar",
                        functools.partial(J_dibr.dibr_render_pair_planar, interpret=True))
    jcfg = J_programs.ProgramConfig(display_mode=mode, emit_depth=emit, **CFG)
    bound = J_programs.BoundModel.stateless(JDepthAnything(**TINY).apply, params)
    jprog = J_programs.ProgramCache(jcfg, bound, JSpec(**SPEC), compute_dtype=jnp.float32)
    tprog = _port_cache(model, mode, emit)

    for frame in _frames():
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        assert t_sbs.shape == j_sbs.shape == ((180, 320, 3))
        assert t_sbs.dtype == np.uint8
        assert t_depth.shape == j_depth.shape == ((70, 126) if emit == "model" else (180, 320))
        # the golden regression's thresholds (tests/test_golden_regression.py)
        diff = np.abs(t_sbs.astype(np.int32) - j_sbs.astype(np.int32))
        assert diff.max() <= 3, diff.max()
        assert (diff > 1).mean() < 0.01, (diff > 1).mean()
        assert np.abs(t_depth - j_depth).max() < 5e-3


@pytest.mark.parametrize("cfg_kw,match", [
    (dict(display_mode="Full-SBS"), "A2"),
    (dict(display_mode="Half-SBS", quality="fast"), "A2"),
    (dict(display_mode="Half-SBS", fill_16_9=True), "A2"),
])
def test_unported_settings_raise(tiny, cfg_kw, match):
    kw = dict(CFG, **cfg_kw)
    with pytest.raises(NotImplementedError, match=match):
        T_programs.ProgramCache(T_programs.ProgramConfig(**kw), tiny[1], TSpec(**SPEC),
                                compute_dtype=torch.float32)


def test_odd_halved_axis_raises(tiny):
    prog = _port_cache(tiny[1], "Half-SBS", "model")
    with pytest.raises(NotImplementedError, match="even width"):
        prog(np.zeros((90, 161, 4), np.uint8))


def test_state_is_per_stream_and_shape(tiny):
    prog = _port_cache(tiny[1], "Half-SBS", "model")
    f0, f1, _ = _frames()
    a0, _ = prog(f0, stream=0)
    b0, _ = prog(f1, stream=1)  # a fresh stream starts its own EMA
    fresh = _port_cache(tiny[1], "Half-SBS", "model")
    assert torch.equal(b0, fresh(f1)[0])
    assert set(prog._states) == {(0, 180, 320), (1, 180, 320)}
    prog.reset()
    assert not prog._states


class _LockstepSource:
    """Hands out the next frame only after the sink received the previous
    one, so latest-wins never drops a frame and all must be delivered."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.delivered = threading.Event()
        self.delivered.set()

    def grab(self):
        if not self.frames:
            return None
        assert self.delivered.wait(timeout=60.0), "sink stalled"
        self.delivered.clear()
        return self.frames.pop(0)


class _RecordingSink:
    wants_depth = True

    def __init__(self, source):
        self.source = source
        self.pushed = []

    def push(self, sbs, depth, stats):
        self.pushed.append((np.array(sbs), np.array(depth)))
        self.source.delivered.set()


def test_engine_delivers_every_frame_including_the_last(tiny):
    frames = _frames(5)
    prog = _port_cache(tiny[1], "Half-SBS", "model")
    prog.warmup((180, 320, 4))
    source = _LockstepSource(frames)
    sink = _RecordingSink(source)
    stats = FrameEngine(source, prog, sink, target_fps=0.0).run(duration=120.0)
    assert stats.frames == 5 and len(sink.pushed) == 5
    direct = _port_cache(tiny[1], "Half-SBS", "model")
    for (sbs, depth), frame in zip(sink.pushed, frames):
        want_sbs, want_depth = direct(frame)
        np.testing.assert_array_equal(sbs, want_sbs.numpy())
        np.testing.assert_array_equal(depth, want_depth.numpy())
