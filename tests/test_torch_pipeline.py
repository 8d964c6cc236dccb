"""The whole slice: the port's ProgramCache and FrameEngine against the JAX
package's ProgramCache, on the CPU in f32.

The JAX side takes its TPU dispatch: `programs._stereo_on_tpu` and
`stereo._on_tpu` return True, and the Pallas kernels it reaches (the DIBR
pair kernel K1 in both its output modes, the warp K3, the single-eye DIBR
K5) run in interpret mode behind call counters.  On the CPU the JAX
ProgramCache would otherwise take its jnp paths, which warp Half-SBS at full
width and squeeze after; the flagship path (and the port) squeezes first.
The JAX stereo code swallows a kernel failure and takes its jnp path, so
each case asserts that the kernel it needs ran.  Both sides run the same
tiny Depth-Anything with the same weights (drawn with numpy from a seed,
moved over with `from_flax`) over three frames, so the EMA carry is
exercised.  The JAX programs take seconds each to compile (the Pallas
kernels in interpret mode), so cases that differ only in display mode share
one JAX ProgramCache and switch it live, as the viewer's hot key does: the
model program is compiled once and each mode's tail once.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.ops.pallas.dibr as J_dibr
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.ops.pallas.warp as J_warp
import desktop2stereo_tpu.ops.stereo as J_stereo
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
from torch_threads import one_torch_thread  # noqa: F401

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


def _seeded_params(module, sample, seed=0):
    """The flax parameters of `module`, drawn with numpy from a seed (no
    init program is compiled): fan-in scaled normal kernels, unit norm and
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


@pytest.fixture(scope="module")
def tiny():
    params = _seeded_params(JDepthAnything(**TINY), jnp.zeros((1, 28, 42, 3), jnp.float32))
    model = DepthAnything(**TINY).eval()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return params, model


def _port_cache(model, mode, emit, **kw):
    cfg = T_programs.ProgramConfig(**dict(CFG, display_mode=mode, emit_depth=emit, **kw))
    return T_programs.ProgramCache(cfg, model, TSpec(**SPEC), compute_dtype=torch.float32)


class _Counted:
    """A JAX Pallas entry point run in interpret mode, counting the calls
    that returned (the calls made while a program is traced)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, *args, **kw):
        out = self.fn(*args, **dict(kw, interpret=True))
        self.calls += 1
        return out


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX TPU dispatch with counted interpret-mode kernels, for the
    module (the shared JAX caches trace a mode's tail at its first switch)."""
    counted = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J_programs, "_stereo_on_tpu", lambda: True)
        mp.setattr(J_stereo, "_on_tpu", lambda: True)
        # each entry point is counted: a jitted one is traced once per shape,
        # so the entry a program calls is the one whose count moves
        for mod, name in ((J_dibr, "dibr_render_pair_planar"), (J_dibr, "dibr_render_pair"),
                          (J_warp, "horizontal_sample"), (J_dibr, "dibr_warp_fill_blend")):
            counted[name] = _Counted(getattr(mod, name))
            mp.setattr(mod, name, counted[name])
        yield counted


@pytest.fixture(scope="module")
def jax_caches(tiny, jax_kernels):
    """`get(mode, emit, **kw)`: a JAX ProgramCache for those settings with
    no carried state; settings that differ only in display mode share one
    cache, switched live."""
    caches = {}
    bound = J_programs.BoundModel.stateless(JDepthAnything(**TINY).apply, tiny[0])

    def get(mode, emit, **kw):
        key = (emit, tuple(sorted(kw.items())))
        prog = caches.get(key)
        if prog is None:
            jcfg = J_programs.ProgramConfig(**dict(CFG, display_mode=mode, emit_depth=emit,
                                                   **kw))
            prog = caches[key] = J_programs.ProgramCache(jcfg, bound, JSpec(**SPEC),
                                                         compute_dtype=jnp.float32)
        prog.set_display_mode(mode)
        prog.reset()
        return prog

    return get


def _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth):
    assert t_sbs.shape == j_sbs.shape and t_sbs.dtype == np.uint8
    assert t_depth.shape == j_depth.shape
    # the golden regression's thresholds (tests/test_golden_regression.py)
    diff = np.abs(t_sbs.astype(np.int32) - j_sbs.astype(np.int32))
    assert diff.max() <= 3, diff.max()
    assert (diff > 1).mean() < 0.01, (diff > 1).mean()
    assert np.abs(t_depth - j_depth).max() < 5e-3


@pytest.mark.parametrize("mode,emit", [("Half-SBS", "model"), ("Half-TAB", "full")])
def test_slice_matches_jax_fused_branch(tiny, jax_kernels, jax_caches, mode, emit):
    calls = jax_kernels["dibr_render_pair_planar"].calls
    jprog = jax_caches(mode, emit)
    tprog = _port_cache(tiny[1], mode, emit)
    for frame in _frames():
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        assert t_sbs.shape == (180, 320, 3)
        assert t_depth.shape == ((70, 126) if emit == "model" else (180, 320))
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
    assert jax_kernels["dibr_render_pair_planar"].calls > calls


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    """The tiny model's weights quantized by the JAX package, in both
    packages' int8 models."""
    qparams = jax.tree.map(np.asarray, J_quant.quantize_tree(tiny[0]))
    model = DepthAnything(**TINY, quant=True).eval()
    model.load_state_dict(from_flax(qparams), strict=True)
    return qparams, model


def test_slice_matches_jax_fused_branch_int8(tiny_int8, jax_kernels):
    """The int8 encoder (`quant="int8"`) through the fused Half-SBS branch;
    the JAX model on its CPU dispatch (`xla_quant_dense`)."""
    qparams, model = tiny_int8
    calls = jax_kernels["dibr_render_pair_planar"].calls
    jcfg = J_programs.ProgramConfig(**dict(CFG, display_mode="Half-SBS", emit_depth="model"))
    bound = J_programs.BoundModel.stateless(JDepthAnything(**TINY, quant=True).apply, qparams)
    jprog = J_programs.ProgramCache(jcfg, bound, JSpec(**SPEC), compute_dtype=jnp.float32)
    tprog = _port_cache(model, "Half-SBS", "model")
    assert tprog.device == torch.device("cpu")  # from the float parameters
    for frame in _frames():
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        assert t_sbs.shape == (180, 320, 3) and t_depth.shape == (70, 126)
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
    assert jax_kernels["dibr_render_pair_planar"].calls > calls


MODE_SHAPES = {"Full-SBS": (180, 640, 3), "Full-TAB": (360, 320, 3)}


def _check_generic_case(tiny, jax_kernels, jax_caches, mode, quality, extra, hw, kernel):
    """Three frames through both caches; shapes, the golden's thresholds, and
    the JAX kernel entry that must have run (traced for this case)."""
    calls = jax_kernels[kernel].calls if kernel is not None else 0
    jprog = jax_caches(mode, "full", quality=quality, **extra)
    tprog = _port_cache(tiny[1], mode, "full", quality=quality, **extra)
    want_shape = MODE_SHAPES.get(mode, (180, 320, 3)) if hw == (180, 320) else None
    for frame in _frames(h=hw[0], w=hw[1]):
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        assert want_shape is None or t_sbs.shape == want_shape
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
    if kernel is not None:
        assert jax_kernels[kernel].calls > calls, kernel


# (mode, quality, extra config, capture (h, w), the JAX kernel entry); the
# high quality display modes are in test_torch_generic.py
@pytest.mark.parametrize("mode,quality,extra,hw,kernel", [
    pytest.param("Half-SBS", "fast", {}, (180, 320), "horizontal_sample", id="fast-Half-SBS"),
    pytest.param("Full-TAB", "fast", {}, (180, 320), "horizontal_sample", id="fast-Full-TAB"),
    # settings the first slice refused, now generic-tail cases
    pytest.param("Half-SBS", "high", dict(fill_16_9=True), (240, 240), "dibr_render_pair",
                 id="fill_16_9-240x240"),
    pytest.param("Half-SBS", "high", {}, (90, 161), "dibr_render_pair", id="odd-width-161"),
])
def test_generic_tail_matches_jax(tiny, jax_kernels, jax_caches, mode, quality, extra, hw,
                                  kernel):
    _check_generic_case(tiny, jax_kernels, jax_caches, mode, quality, extra, hw, kernel)


@pytest.mark.parametrize("field,value", [("display_mode", "Checkerboard"),
                                         ("quality", "medium"), ("emit_depth", "none")])
def test_unknown_settings_raise(tiny, field, value):
    cfg = T_programs.ProgramConfig(**dict(CFG, **{"display_mode": "Half-SBS", field: value}))
    with pytest.raises(ValueError, match=value):
        T_programs.ProgramCache(cfg, tiny[1], TSpec(**SPEC), compute_dtype=torch.float32)


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


def test_engine_needs_the_program_device():
    """No device on the program: FrameEngine raises instead of staging the
    frames on the CPU."""
    with pytest.raises(ValueError, match="device"):
        FrameEngine(_LockstepSource([]), lambda frame: frame, _RecordingSink(None))


def test_init_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the host without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        T_programs.init_state(70, 126)
    assert T_programs.init_state(70, 126, device="cpu").ema_depth.isnan().all()


class _HookedModel(torch.nn.Module):
    """The model, with a hook that runs inside every forward pass (in the
    middle of a frame)."""

    def __init__(self, model, hook):
        super().__init__()
        self.model = model
        self.hook = hook

    def forward(self, x):
        self.hook()
        return self.model(x)


def test_live_switches_apply_at_the_next_frame(tiny):
    """Mode, strength and feather switched from a second thread while a
    frame runs take effect at the start of the next frame; each frame equals
    a fresh program with that frame's settings on the same EMA carry, and
    the carry survives every switch."""
    model = tiny[1]
    actions = [lambda p: p.cycle_display_mode(),          # Half-SBS → Full-SBS
               lambda p: p.adjust_depth_strength(0.5),    # 2.0 → 2.5
               lambda p: p.toggle_feather(),
               lambda p: p.set_display_mode("Full-TAB"),
               lambda p: p.set_depth_strength(20.0),      # clamped to 10
               lambda p: p.cycle_display_mode(-1),        # Full-TAB → Half-TAB
               lambda p: p.reset_depth_strength(),
               lambda p: p.set_display_mode("Depth")]
    requested, switched = threading.Event(), threading.Event()
    prog = None
    calls = []

    def in_frame():  # the frame thread waits while the other thread switches
        calls.append(1)
        if len(calls) > len(actions):
            return
        requested.set()
        assert switched.wait(timeout=60.0), "switcher stalled"
        switched.clear()

    def switcher():
        for act in actions:
            assert requested.wait(timeout=60.0)
            requested.clear()
            act(prog)
            switched.set()

    prog = _port_cache(_HookedModel(model, in_frame), "Half-SBS", "model")
    plain = _port_cache(model, "Half-SBS", "model")  # never switched: the EMA reference
    frames = _frames(len(actions) + 1)
    thread = threading.Thread(target=switcher, daemon=True)
    thread.start()
    state = T_programs.init_state(*T_programs.ema_shape(prog.cfg, prog.spec, 180, 320),
                                  device="cpu")
    used = []
    for frame in frames:
        before = prog.cfg
        sbs, depth = prog(frame)
        used.append(prog.cfg)
        want = T_programs.FrameProgram(prog.cfg, model, prog.spec, torch.float32)
        with torch.inference_mode():
            want_sbs, _, _ = want(torch.from_numpy(frame), state)
        assert torch.equal(sbs, want_sbs), prog.cfg
        _, plain_depth = plain(frame)
        assert torch.equal(depth, plain_depth)  # the EMA carry is untouched
        state = T_programs.FrameState(ema_depth=plain_depth)
        assert before == (used[-2] if len(used) > 1 else prog.cfg)
    thread.join(timeout=10.0)
    keys = [(c.display_mode, c.depth_strength, c.edge_feather) for c in used]
    assert keys == [("Half-SBS", 2.0, False), ("Full-SBS", 2.0, False),
                    ("Full-SBS", 2.5, False), ("Full-SBS", 2.5, True),
                    ("Full-TAB", 2.5, True), ("Full-TAB", 10.0, True),
                    ("Half-TAB", 10.0, True), ("Half-TAB", 2.0, True),
                    ("Depth", 2.0, True)]
    assert prog.display_mode == "Depth" and prog.edge_feather


def test_live_switch_setters_lose_no_update(tiny):
    """Setters racing on many threads: each read-modify-write holds the lock,
    so no adjustment and no toggle is lost."""
    import sys

    prog = _port_cache(tiny[1], "Half-SBS", "model")
    n_threads, steps = 16, 25

    def worker():
        for _ in range(steps):
            prog.adjust_depth_strength(0.01)
            prog.toggle_feather()
            prog.cycle_display_mode()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * steps
    assert prog.depth_strength == pytest.approx(2.0 + 0.01 * total, abs=1e-9)
    assert prog.edge_feather is bool(total % 2)
    assert prog.display_mode == DISPLAY_MODES[total % len(DISPLAY_MODES)]
