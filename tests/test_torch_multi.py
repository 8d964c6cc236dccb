"""Multi-stream serving in the port (`pipeline/multi.py`, the batched
`FrameProgram` and `BatchedProgramCache`) against the JAX package on the
CPU in f32.

- `BatchedProgramCache` against JAX's, on one tiny Depth-Anything with the
  same weights (as `tests/test_torch_pipeline.py` moves them): the fused
  Half-SBS tail (the JAX side on its TPU dispatch, the Pallas kernels in
  interpret mode behind call counters, vmapped over the streams), the
  generic high tail (K1 eyes over the stream axis) and the fast one (K3 a
  row).  Each row within that file's thresholds: SBS at most 3 LSB off and
  under 1% of values more than 1 LSB; depth within 5e-3.
- The port's versions of the ten cases of `tests/test_multi_stream.py`,
  with the models as modules (the port's programs take `nn.Module`s).  The
  late-stream case checks the order of the first pushes, not the wall
  clock (ROADMAP C2), and the real-VDA case runs at a tiny width.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from desktop2stereo_tpu_torch.pipeline.multi import BatchedStreamEngine, MultiStreamEngine
from test_torch_pipeline import (  # noqa: F401
    CFG, SPEC, TINY, _assert_frames_match, _frames, jax_kernels, tiny)
from torch_threads import one_torch_thread  # noqa: F401


def _two_feeds(n=3):
    """Two different 180x320 streams: the pipeline test's scene and its
    mirror image, n frames each."""
    a = _frames(n)
    return a, [np.ascontiguousarray(f[:, ::-1]) for f in a]


@pytest.mark.parametrize("mode,quality,emit", [("Half-SBS", "high", "model"),
                                               ("Full-SBS", "high", "full"),
                                               ("Half-SBS", "fast", "model")],
                         ids=["fused", "generic_high", "generic_fast"])
def test_batched_program_matches_jax_batched(tiny, jax_kernels, mode, quality, emit):  # noqa: F811
    """Three steps of two streams through both BatchedProgramCaches, and each
    row against the port's single-stream ProgramCache on that stream."""
    params, model = tiny
    kw = dict(CFG, display_mode=mode, quality=quality, emit_depth=emit)
    bound = J_programs.BoundModel.stateless(JDepthAnything(**TINY).apply, params)
    jprog = J_programs.BatchedProgramCache(J_programs.ProgramConfig(**kw), bound, JSpec(**SPEC),
                                           compute_dtype=jnp.float32, num_streams=2)
    tcfg = T_programs.ProgramConfig(**kw)
    tprog = T_programs.BatchedProgramCache(tcfg, model, TSpec(**SPEC),
                                           compute_dtype=torch.float32, num_streams=2)
    singles = [T_programs.ProgramCache(tcfg, model, TSpec(**SPEC), compute_dtype=torch.float32)
               for _ in range(2)]
    counter = {"high": "dibr_render_pair_planar", "fast": "horizontal_sample"}[quality]
    calls = jax_kernels[counter].calls
    feeds = _two_feeds()
    out_shape = (180, 640, 3) if mode == "Full-SBS" else (180, 320, 3)
    for t in range(3):
        batch = np.stack([feeds[0][t], feeds[1][t]])
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(batch)))
        t_sbs, t_depth = (a.numpy() for a in tprog(batch))
        assert t_sbs.shape == (2, *out_shape) and t_sbs.dtype == np.uint8
        for s in range(2):
            _assert_frames_match(j_sbs[s], j_depth[s], t_sbs[s], t_depth[s])
            one_sbs, one_depth = (a.numpy() for a in singles[s](feeds[s][t]))
            _assert_frames_match(one_sbs, one_depth, t_sbs[s], t_depth[s])
    assert set(tprog._states) == {(2, 180, 320)}
    assert tprog._states[(2, 180, 320)].ema_depth.shape == (2, 70, 126)
    assert jax_kernels[counter].calls > calls


def test_batched_program_keeps_the_live_switches(tiny):
    """A mode switch applies at the next step and the stacked EMA carry
    survives it; the setters are ProgramCache's."""
    model = tiny[1]
    cfg = T_programs.ProgramConfig(**dict(CFG, display_mode="Half-SBS", emit_depth="model"))
    prog = T_programs.BatchedProgramCache(cfg, model, TSpec(**SPEC), compute_dtype=torch.float32,
                                          num_streams=2)
    feeds = _two_feeds(2)
    prog(np.stack([feeds[0][0], feeds[1][0]]))
    carry = prog._states[(2, 180, 320)].ema_depth
    assert prog.cycle_display_mode() == "Full-SBS" and prog.display_mode == "Full-SBS"
    assert prog.set_depth_strength(99.0) == prog.MAX_DEPTH_STRENGTH
    assert prog.toggle_feather() is True
    sbs, _ = prog(np.stack([feeds[0][1], feeds[1][1]]))
    assert sbs.shape == (2, 180, 640, 3)
    assert prog.cfg.display_mode == "Full-SBS" and prog.cfg.edge_feather
    assert not torch.equal(prog._states[(2, 180, 320)].ema_depth, carry)  # carried, advanced
    with pytest.raises(ValueError, match=r"takes frames \[2,H,W,C\]"):
        prog(np.zeros((3, 180, 320, 4), np.uint8))
    report = prog.warmup((180, 320, 4))
    assert set(report) == {"pre_s", "model_s", "post_s", "stereo_s"} and not prog._states


# ---- the engines: the port's versions of tests/test_multi_stream.py ----------------------------

def make_cfg(**kw):
    base = dict(
        model_name="Depth-Anything-V2-Small",
        depth_resolution=98,
        output_height=64,
        display_mode="Half-SBS",
        ipd=0.064,
        depth_strength=1.0,
        convergence=0.0,
        foreground_scale=0.0,
        aa_strength=0.0,
        ema_alpha=0.9,
        temporal_smooth=True,
        quality="fast",
    )
    base.update(kw)
    return T_programs.ProgramConfig(**base)


class FakeModel(torch.nn.Module):
    """pixels → depth, the JAX test's `fake_model` as a module."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))  # the program's device

    def forward(self, pixels):
        return pixels[..., 0] * 0.5 + 0.25


class CounterModel(FakeModel):
    """A streaming toy: depth = luminance + 0.01·counter, one counter a
    batch row (a real per-stream carry)."""

    carry_per_stream = True

    def first(self, x):
        return x[..., 0] * 0.004, (torch.zeros(x.shape[0]),)

    def step(self, x, carry):
        (counter,) = carry
        return x[..., 0] * 0.004 + 0.01 * counter[:, None, None], (counter + 1.0,)


def program(cfg, model=None):
    return T_programs.ProgramCache(cfg, model or FakeModel(), compute_dtype=torch.float32)


def batched(cfg, model=None, streams=2):
    return T_programs.BatchedProgramCache(cfg, model or FakeModel(), compute_dtype=torch.float32,
                                          num_streams=streams)


class ListSource:
    def __init__(self, frames):
        self._frames = list(frames)

    def grab(self):
        return self._frames.pop(0) if self._frames else None


class CollectSink:
    def __init__(self):
        self.frames = []
        self.stats = []

    def push(self, sbs, depth, stats):
        self.frames.append(np.asarray(sbs).copy())
        self.stats.append(stats)


def test_two_streams_independent_state():
    """A bright feed lit along x and a dark one along y (a flat frame's
    normalised depth is rounding noise): each stream's EMA and output are
    its own."""
    ramp = np.linspace(-20, 20, 96)[None, :, None] + np.zeros((64, 1, 4))
    bright = [np.uint8(230 + ramp) for _ in range(6)]
    dark = [np.uint8(20 + np.linspace(-20, 20, 64)[:, None, None] + np.zeros((1, 96, 4)))
            for _ in range(6)]
    prog = program(make_cfg())
    sinks = [CollectSink(), CollectSink()]
    eng = MultiStreamEngine([ListSource(bright), ListSource(dark)], prog, sinks,
                            target_fps=200.0)
    stats = eng.run(duration=20.0)

    assert sinks[0].frames and sinks[1].frames
    assert {k[0] for k in prog._states} == {0, 1}  # (stream, oh, ow) keys
    s0 = prog._states[(0, 64, 96)].ema_depth
    s1 = prog._states[(1, 64, 96)].ema_depth
    assert float((s0 - s1).abs().max()) > 0.1  # the EMA carries differ
    assert sinks[0].frames[-1].mean() > sinks[1].frames[-1].mean() + 50
    assert stats["stream0"]["frames"] > 0 and stats["stream1"]["frames"] > 0
    assert sinks[0].stats[-1]["stream"] == 0


def test_batched_engine_matches_sequential():
    """BatchedStreamEngine's frames equal the sequential program's for fresh
    inputs (latest-wins may skip a frame, never invent one)."""
    rng = np.random.default_rng(1)
    feeds = [[rng.integers(0, 255, (48, 64, 4), np.uint8) for _ in range(4)] for _ in range(2)]
    cfg = make_cfg(output_height=48, temporal_smooth=False)
    seq = program(cfg)
    want = {0: [], 1: []}
    for i in range(4):
        for s in range(2):
            want[s].append(seq(feeds[s][i], stream=s)[0].numpy())

    sinks = [CollectSink(), CollectSink()]
    eng = BatchedStreamEngine([ListSource([f.copy() for f in feeds[0]]),
                               ListSource([f.copy() for f in feeds[1]])],
                              batched(cfg), sinks, target_fps=30.0)
    eng.run(duration=30.0)
    for s in range(2):
        assert sinks[s].frames, f"stream {s} produced nothing"
        for got in sinks[s].frames:
            assert any(np.array_equal(got, w) for w in want[s]), \
                f"stream {s} frame matches no sequential output"


def test_batched_streaming_matches_per_stream():
    """A streaming model batches with one carry row a stream: S batched
    streams equal S independent ProgramCaches frame for frame."""
    model = CounterModel()
    rng = np.random.default_rng(11)
    clips = [rng.integers(0, 255, (4, 48, 64, 4), np.uint8) for _ in range(2)]
    prog = batched(make_cfg(), model)
    singles = [program(make_cfg(), model) for _ in range(2)]
    assert prog.stateful
    for t in range(4):
        sbs_b, dep_b = prog(np.stack([clips[0][t], clips[1][t]]))
        for s in range(2):
            sbs_s, dep_s = singles[s](clips[s][t])
            np.testing.assert_allclose(dep_b[s].numpy(), dep_s.numpy(), atol=1e-5)
            np.testing.assert_array_equal(sbs_b[s].numpy(), sbs_s.numpy())


def test_batched_survives_empty_stream():
    """A stream whose source never yields must not starve the live one."""
    cfg = make_cfg(output_height=32, temporal_smooth=False)
    sinks = [CollectSink(), CollectSink()]
    frames = [np.zeros((32, 48, 4), np.uint8) for _ in range(3)]
    eng = BatchedStreamEngine([ListSource(frames), ListSource([])], batched(cfg), sinks,
                              target_fps=100.0)
    eng.run(duration=20.0)
    assert sinks[0].frames, "live stream starved by the empty one"
    assert not sinks[1].frames  # stand-ins never reach the dead stream's sink


def test_batched_rejects_mixed_shapes():
    cfg = make_cfg(output_height=32, temporal_smooth=False)
    eng = BatchedStreamEngine([ListSource([np.zeros((32, 48, 4), np.uint8)]),
                               ListSource([np.zeros((40, 64, 4), np.uint8)])],
                              batched(cfg), [CollectSink(), CollectSink()], target_fps=100.0)
    with pytest.raises(RuntimeError, match="uniform frame shapes"):
        eng.run(duration=15.0)


def test_exhausted_stream_pending_flushes_while_other_runs():
    """Stream A ends while stream B keeps the compute loop busy: A's final
    frame still reaches its sink."""
    class EndlessSource:
        def __init__(self):
            self.n = 0

        def grab(self):
            self.n += 1
            return np.full((32, 48, 4), self.n % 255, np.uint8)

    cfg = make_cfg(output_height=32, temporal_smooth=False)
    sinks = [CollectSink(), CollectSink()]
    eng = MultiStreamEngine([ListSource([np.zeros((32, 48, 4), np.uint8)]), EndlessSource()],
                            program(cfg), sinks, target_fps=200.0)
    eng.start()
    t_end = time.monotonic() + 20
    while time.monotonic() < t_end and not sinks[0].frames:
        time.sleep(0.05)
    eng.shutdown.set()
    for t in eng._threads:
        t.join(timeout=5.0)
    assert sinks[0].frames, "finite stream's last frame was withheld"


def test_stream_exhaustion_and_latest_wins():
    frames = [np.zeros((32, 64, 4), np.uint8) for _ in range(3)]
    sink = CollectSink()
    eng = MultiStreamEngine([ListSource(frames)], program(make_cfg(output_height=32)), [sink],
                            target_fps=500.0)
    eng.run(duration=20.0)
    # every source exhausted: the engine stops on its own, one frame or more delivered
    assert 1 <= len(sink.frames) <= 3
    assert eng.streams[0].done.is_set()


def test_batched_real_vda_streams_are_independent():
    """Two batched streams of a real (tiny) VDA: each stream's rolling
    31-frame cache sees only its own content, as S single streams."""
    from desktop2stereo_tpu_torch.models.factory import init_random
    from desktop2stereo_tpu_torch.models.vda import VideoDepthAnything

    # channels ≥ 32: the temporal transformer's GroupNorm takes 32 groups
    model = init_random(VideoDepthAnything(
        hidden_size=32, num_layers=4, num_heads=2, mlp_dim=64, out_layers=(0, 1, 2, 3),
        neck_channels=(32, 32, 32, 32), fusion_channels=32, patch_size=14), seed=0).eval()
    cfg = make_cfg(depth_resolution=56)  # a 4x4 grid: GroupNorm needs 2+ values a group
    rng = np.random.default_rng(5)
    clips = [rng.integers(0, 255, (3, 56, 56, 4), np.uint8) for _ in range(2)]
    prog = batched(cfg, model)
    singles = [program(cfg, model) for _ in range(2)]
    for t in range(3):
        _sbs, dep_b = prog(np.stack([clips[0][t], clips[1][t]]))
        for s in range(2):
            _s, dep_s = singles[s](clips[s][t])
            np.testing.assert_allclose(dep_b[s].numpy(), dep_s.numpy(), atol=2e-4, rtol=2e-4)
    caches = prog._states[(2, 56, 56)].model
    assert len(caches) == 8 and all(c.shape[0] == 2 and c.shape[2] == 31 for c in caches)


def test_batched_stale_stream_freezes_model_carry():
    """A step where stream B has no fresh frame (fresh=[True, False])
    advances only stream A's carry; B's row stays bit-equal."""
    prog = batched(make_cfg(), CounterModel())
    frames = np.zeros((2, 48, 64, 4), np.uint8)
    prog(frames)                                  # first: counters [0, 0]
    prog(frames, fresh=np.array([True, False]))
    prog(frames, fresh=np.array([True, True]))
    (counters,) = prog._states[(2, 48, 64)].model
    np.testing.assert_array_equal(counters.numpy(), [2.0, 1.0])


def test_batched_late_stream_does_not_starve_live_ones():
    """A stream whose source has not produced yet (a remote agent still
    connecting) does not block the batch of a stateless program: the live
    stream flows with a stand-in row, and the late stream's sink stays
    silent until its own frame arrives.  Ordering, not wall clock: the late
    source hands out its frame only after the live stream's first push."""
    rng = np.random.default_rng(5)
    frames0 = [rng.integers(0, 255, (48, 64, 4), np.uint8) for _ in range(8)]
    frame1 = rng.integers(0, 255, (48, 64, 4), np.uint8)
    first_push = threading.Event()
    order = []

    class LateSource:
        def __init__(self):
            self._frames = [frame1]

        def grab(self):
            # a starved batch never pushes: the wait ends at its timeout
            # and the ordering check below fails
            first_push.wait(timeout=60.0)
            return self._frames.pop(0) if self._frames else None

    class OrderSink(CollectSink):
        def __init__(self, idx):
            super().__init__()
            self.idx = idx

        def push(self, sbs, depth, stats):
            if not self.frames:
                order.append(self.idx)
            super().push(sbs, depth, stats)
            first_push.set()

    cfg = make_cfg(output_height=48, temporal_smooth=False)
    sinks = [OrderSink(0), OrderSink(1)]
    eng = BatchedStreamEngine([ListSource([f.copy() for f in frames0]), LateSource()],
                              batched(cfg), sinks, target_fps=30.0)
    eng.run(duration=60.0)
    assert sinks[0].frames, "live stream starved by the late one"
    assert sinks[1].frames, "late stream never delivered"
    assert order == [0, 1]  # the live stream's first push did not wait for the late one
    # the late stream's sink got its own frame only, never a stand-in
    want = program(cfg)(frame1, stream=1)[0].numpy()
    assert all(np.array_equal(f, want) for f in sinks[1].frames)
