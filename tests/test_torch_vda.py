"""The port's Video-Depth-Anything (`models/vda.py`) and its streaming
through `ProgramCache`, against the JAX package on the CPU in f32.

Both sides take the same weights: `synth_state_dict` of
`tests/test_models_vda.py` (the original VDA naming, ViT-S dims) through
each package's `convert_vda`, and `from_flax` of the tree for the port.
The model runs the JAX test's tiny input sizes; the frame program runs
180x320 frames at depth resolution 126 (a 70x126 model input), with the
JAX side on its TPU dispatch and its DIBR kernel in interpret mode, as in
`tests/test_torch_pipeline.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.models.vda as J_vda
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models import convert_hf as J_convert
from desktop2stereo_tpu.models.dinov2 import Dinov2Embeddings as JEmbeddings
from desktop2stereo_tpu.ops.resize import resize_weights as J_resize_weights
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models import vda as T_vda
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Embeddings
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.ops.resize import resize_weights
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
from test_models_vda import TINY_SPEC, synth_state_dict
from test_torch_pipeline import (  # noqa: F401
    _assert_frames_match, _frames, _LockstepSource, _RecordingSink, jax_kernels)
from torch_threads import one_torch_thread  # noqa: F401

REL_TOL = 5e-4  # f32 parity, as tests/test_torch_models.py
SPEC = dict(name="vda-test", family="vda", variant="vits", hf_repo="none")
CFG = dict(model_name="vda-test", depth_resolution=126, output_height=180,
           ipd=0.064, depth_strength=2.0, convergence=0.01, foreground_scale=0.0,
           aa_strength=2.0, ema_alpha=0.9, temporal_smooth=True, quality="high",
           emit_depth="model")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port model) from one synthesized VDA-Small checkpoint."""
    sd = synth_state_dict(np.random.default_rng(11))
    jtree = J_convert.convert_vda(sd, TINY_SPEC)
    model = T_vda.VideoDepthAnything.from_spec(TSpec(**SPEC)).eval()
    model.load_state_dict(from_flax(T_convert.convert_vda(sd, TSpec(**SPEC))), strict=True)
    return {"params": jtree}, model


@pytest.fixture(scope="module")
def jax_fns():
    _, first, step = J_vda.make_vda_fns(J_vda.VideoDepthAnything.from_spec(TINY_SPEC))
    return jax.jit(first), jax.jit(step)


def _inputs(n, hw=(42, 56), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, *hw, 3)).astype(np.float32) for _ in range(n)]


def test_converters_give_the_jax_tree():
    sd = synth_state_dict(np.random.default_rng(4))
    want = jax.tree_util.tree_leaves_with_path(J_convert.convert_vda(sd, TINY_SPEC))
    got = dict(jax.tree_util.tree_leaves_with_path(T_convert.convert_vda(sd, TSpec(**SPEC))))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", ["batch", "streaming"])
@pytest.mark.parametrize("site", [0, 3])
def test_temporal_transformer_matches_jax(weights, mode, site):
    params = weights[0]["params"]["head"][f"temporal_{site}"]
    C = params["proj_in"]["kernel"].shape[0]
    tt = T_vda.TemporalTransformer(C).eval()
    tt.load_state_dict(from_flax(params), strict=True)
    rng = np.random.default_rng(site)
    B, H, W = 1, 2, 3
    if mode == "batch":
        x = rng.standard_normal((B, 3, H, W, C)).astype(np.float32)
        caches = None
    else:
        x = rng.standard_normal((B, 1, H, W, C)).astype(np.float32)
        caches = [rng.standard_normal((B, H * W, 7, C)).astype(np.float32) for _ in range(2)]
    want, want_e = J_vda.TemporalTransformer(C).apply(
        {"params": params}, jnp.asarray(x), None if caches is None else tuple(map(jnp.asarray, caches)))
    with torch.no_grad():
        got, got_e = tt(torch.from_numpy(x),
                        None if caches is None else [torch.from_numpy(c) for c in caches])
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < REL_TOL
    for g, w in zip(got_e, want_e):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) < REL_TOL


def test_first_step_step_matches_jax(weights, jax_fns):
    """Three streamed frames: depth and all eight caches within REL_TOL."""
    params, model = weights
    first, step = jax_fns
    jstate = tstate = None
    for i, x in enumerate(_inputs(3)):
        if jstate is None:
            jd, jstate = first(params, jnp.asarray(x))
            with torch.no_grad():
                td, tstate = model.first(torch.from_numpy(x))
        else:
            jd, jstate = step(params, jnp.asarray(x), jstate)
            with torch.no_grad():
                td, tstate = model.step(torch.from_numpy(x), tstate)
        assert td.shape == jd.shape == (1, 42, 56)
        assert _rel(td.numpy(), jd) < REL_TOL, i
        assert len(tstate) == len(jstate.caches) == T_vda.NUM_SITES
        for s, (c, jc) in enumerate(zip(tstate, jstate.caches)):
            assert c.shape == jc.shape and c.shape[2] == T_vda.CACHE_LEN
            assert _rel(c.numpy(), jc) < REL_TOL, (i, s)


def test_state_updates_equal_jax_exactly():
    rng = np.random.default_rng(8)
    caches = [rng.standard_normal((1, p, T_vda.CACHE_LEN, c)).astype(np.float32)
              for p, c in ((6, 8), (2, 16))]
    entries = [rng.standard_normal((1, p, 1, c)).astype(np.float32) for p, c in ((6, 8), (2, 16))]
    want = J_vda.update_state(J_vda.VDAState(tuple(map(jnp.asarray, caches))),
                              list(map(jnp.asarray, entries))).caches
    got = T_vda.update_state(tuple(map(torch.from_numpy, caches)),
                             list(map(torch.from_numpy, entries)))
    for g, w, c, e in zip(got, want, caches, entries):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[:, :, :-1], c[:, :, 1:])  # shifted left
        np.testing.assert_array_equal(g.numpy()[:, :, -1:], e)            # appended
    want = J_vda.init_state_from_entries(list(map(jnp.asarray, entries))).caches
    got = T_vda.init_state_from_entries(list(map(torch.from_numpy, entries)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_int8_first_step_matches_jax(weights):
    """`quant="int8"`: the encoder's products on the int8 dense (its plain
    version here), the head float; the JAX model on its CPU dispatch
    (`xla_quant_dense`), over a first frame and one step."""
    qparams = jax.tree.map(np.asarray, J_quant.quantize_tree(weights[0]))
    model = T_vda.VideoDepthAnything.from_spec(TSpec(**SPEC), quant=True).eval()
    model.load_state_dict(from_flax(qparams), strict=True)
    _, first, step = J_vda.make_vda_fns(J_vda.VideoDepthAnything.from_spec(TINY_SPEC, quant=True))
    x0, x1 = _inputs(2, seed=12)
    jd0, jstate = jax.jit(first)(qparams, jnp.asarray(x0))
    jd1, jstate = jax.jit(step)(qparams, jnp.asarray(x1), jstate)
    with torch.no_grad():
        td0, tstate = model.first(torch.from_numpy(x0))
        td1, tstate = model.step(torch.from_numpy(x1), tstate)
    assert _rel(td0.numpy(), jd0) < REL_TOL and _rel(td1.numpy(), jd1) < REL_TOL
    for c, jc in zip(tstate, jstate.caches):
        assert _rel(c.numpy(), jc) < REL_TOL


def test_clip_mode_matches_jax_and_refuses_long_clips(weights):
    params, model = weights
    apply, _, _ = J_vda.make_vda_fns(J_vda.VideoDepthAnything.from_spec(TINY_SPEC))
    clip = np.concatenate(_inputs(3, hw=(42, 42), seed=6))
    want = np.asarray(apply(params, jnp.asarray(clip)))
    with torch.no_grad():
        got = model.clip(torch.from_numpy(clip)).numpy()
    assert got.shape == want.shape == (3, 42, 42)
    assert _rel(got, want) < REL_TOL
    with pytest.raises(ValueError, match="streaming"):
        model.clip(torch.zeros(T_vda.INFER_LEN + 1, 28, 28, 3))


def test_streaming_wrapper_restarts_on_a_new_shape(weights):
    _, model = weights
    stream = T_vda.StreamingVDA(model)
    xs = [torch.from_numpy(x) for x in _inputs(3)]
    with torch.no_grad():
        d0, state = model.first(xs[0])
        d1, _ = model.step(xs[1], state)
        d_other, _ = model.first(xs[2][:, :28])
    assert torch.equal(stream.apply(xs[0]), d0)
    assert torch.equal(stream.apply(xs[1]), d1)
    assert torch.equal(stream.apply(xs[2][:, :28]), d_other)  # shape change: first


@pytest.mark.parametrize("grid", [(3, 4), (5, 9), (21, 37), (40, 30)])
def test_offset_position_table_matches_jax(grid):
    """interpolate_offset 0.1 (the original DINOv2 weights): the position
    table sampled at scale (g + 0.1) / 37 on a grid other than 37×37."""
    D, p = 8, 14
    rng = np.random.default_rng(sum(grid))
    params = {"cls_token": rng.standard_normal((1, 1, D)).astype(np.float32),
              "position_embeddings": rng.standard_normal((1, 37 * 37 + 1, D)).astype(np.float32),
              "patch_embeddings": {"kernel": rng.standard_normal((p * p * 3, D)).astype(np.float32),
                                   "bias": rng.standard_normal(D).astype(np.float32)}}
    x = rng.standard_normal((1, grid[0] * p, grid[1] * p, 3)).astype(np.float32)
    want = JEmbeddings(D, p, interpolate_offset=0.1).apply({"params": params}, jnp.asarray(x))
    emb = Dinov2Embeddings(D, p, interpolate_offset=0.1)
    emb.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = emb(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-5
    # and the offset moves the table: 0 gives another one off the 37 grid
    plain = Dinov2Embeddings(D, p)
    plain.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        assert not np.allclose(plain(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("n_in,n_out,scale", [(37, 3, 3.1 / 37), (37, 21, 21.1 / 37),
                                              (37, 37, 37.1 / 37), (37, 52, 52.1 / 37),
                                              (10, 7, 0.5)])
def test_scale_override_weights_equal_jax(n_in, n_out, scale):
    got = resize_weights(n_in, n_out, "bicubic", scale_override=scale)
    want = J_resize_weights(n_in, n_out, "bicubic", False, False, scale)
    np.testing.assert_array_equal(got, want)


# ---- the frame program: ProgramCache with the tiny VDA -----------------------------------

@pytest.fixture(scope="module")
def jax_vda_cache(weights, jax_kernels):  # noqa: F811
    """A JAX ProgramCache around the tiny VDA's first/step (Half-SBS)."""
    _, first, step = J_vda.make_vda_fns(J_vda.VideoDepthAnything.from_spec(TINY_SPEC))
    bound = J_programs.BoundModel(params=weights[0], first=first, step=step)
    cfg = J_programs.ProgramConfig(**dict(CFG, display_mode="Half-SBS"))
    return J_programs.ProgramCache(cfg, bound, JSpec(**SPEC), compute_dtype=jnp.float32)


def _port_cache(model, mode="Half-SBS"):
    cfg = T_programs.ProgramConfig(**dict(CFG, display_mode=mode))
    return T_programs.ProgramCache(cfg, model, TSpec(**SPEC), compute_dtype=torch.float32)


def _assert_carry_matches(tstate, jstate):
    assert len(tstate.model) == len(jstate.model.caches) == T_vda.NUM_SITES
    for c, jc in zip(tstate.model, jstate.model.caches):
        assert c.shape == jc.shape
        assert _rel(c.numpy(), jc) < REL_TOL


def test_program_cache_streams_like_jax_through_a_live_mode_switch(weights, jax_kernels,  # noqa: F811
                                                                   jax_vda_cache):
    """Three frames through both caches, switched live from Half-SBS to
    Half-TAB after the first: frames within the pipeline test's thresholds,
    the carry within REL_TOL, and the same carry as a program never
    switched (it survives the switch)."""
    calls = jax_kernels["dibr_render_pair_planar"].calls
    jprog = jax_vda_cache
    jprog.reset()
    jprog.set_display_mode("Half-SBS")
    tprog, plain = _port_cache(weights[1]), _port_cache(weights[1])
    key = (0, 180, 320)
    for i, frame in enumerate(_frames()):
        if i == 1:
            jprog.set_display_mode("Half-TAB")
            tprog.set_display_mode("Half-TAB")
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        _, plain_depth = plain(frame)
        assert t_sbs.shape == (180, 320, 3) and t_depth.shape == (70, 126)
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
        _assert_carry_matches(tprog._states[key], jprog._states[key])
        assert torch.equal(plain_depth, torch.from_numpy(t_depth))
        for a, b in zip(tprog._states[key].model, plain._states[key].model):
            assert torch.equal(a, b)
    assert tprog.cfg.display_mode == "Half-TAB"
    assert jax_kernels["dibr_render_pair_planar"].calls > calls


def test_a_new_output_size_starts_a_new_carry(weights):
    frames = _frames(3)
    prog = _port_cache(weights[1])
    prog(frames[0])
    prog(frames[1])
    kept = prog._states[(0, 180, 320)].model
    other = frames[2][:, :240]  # a 180x240 capture: another output size
    prog(other)
    assert set(prog._states) == {(0, 180, 320), (0, 180, 240)}
    assert all(a is b for a, b in zip(prog._states[(0, 180, 320)].model, kept))
    fresh = _port_cache(weights[1])
    fresh(other)
    for a, b in zip(prog._states[(0, 180, 240)].model, fresh._states[(0, 180, 240)].model):
        assert torch.equal(a, b)
    # frame 0's entries replicated ×31: the first program built it
    c = prog._states[(0, 180, 240)].model[0]
    assert torch.equal(c[:, :, 0], c[:, :, -1])


class _Counting(torch.nn.Module):
    """The model, counting its first and step calls."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.calls = []

    def first(self, x):
        self.calls.append("first")
        return self.model.first(x)

    def step(self, x, carry):
        self.calls.append("step")
        return self.model.step(x, carry)


def test_warmup_runs_first_then_steps_and_keeps_no_state(weights):
    counted = _Counting(weights[1])
    prog = _port_cache(counted)
    report = prog.warmup((180, 320, 4))
    assert set(report) == {"pre_s", "model_s", "tail_s"}
    assert counted.calls == ["first", "first", "step"]  # the stage timing, then 2 frames
    assert not prog._states
    frame = _frames(1)[0]
    sbs, depth = prog(frame)
    assert counted.calls[-1] == "first"  # a user's first frame starts the window
    want_sbs, want_depth = _port_cache(weights[1])(frame)
    assert torch.equal(sbs, want_sbs) and torch.equal(depth, want_depth)


def test_engine_streams_the_carry_from_the_preloaded_frame(weights):
    """FrameEngine unchanged with a stateful model: the shape probe is
    preloaded as frame 0 (`first`), every later frame steps the same carry,
    and each delivered frame equals the ProgramCache run directly."""
    frames = _frames(4)
    prog = _port_cache(weights[1])
    prog.warmup((180, 320, 4))
    source = _LockstepSource(frames[1:])
    source.delivered.clear()  # the source's first frame waits for frame 0's delivery
    sink = _RecordingSink(source)
    engine = FrameEngine(source, prog, sink, target_fps=0.0)
    engine.preload(frames[0])
    stats = engine.run(duration=120.0)
    assert stats.frames == 4 and len(sink.pushed) == 4
    direct = _port_cache(weights[1])
    for (sbs, depth), frame in zip(sink.pushed, frames):
        want_sbs, want_depth = direct(frame)
        np.testing.assert_array_equal(sbs, want_sbs.numpy())
        np.testing.assert_array_equal(depth, want_depth.numpy())
    for a, b in zip(prog._states[(0, 180, 320)].model, direct._states[(0, 180, 320)].model):
        assert torch.equal(a, b)


def test_batched_program_matches_jax_batched_with_stale_rows(weights, jax_kernels):  # noqa: F811
    """Two streams through both BatchedProgramCaches over four steps, the
    second row stale on step 2 and the first on step 4 (`fresh`): each row's
    frame within the pipeline test's thresholds, the stacked caches
    [2, P, 31, C] within REL_TOL of JAX's, and a stale row's caches
    bit-equal across its step (its EMA still advances, as in JAX)."""
    _, first, step = J_vda.make_vda_fns(J_vda.VideoDepthAnything.from_spec(TINY_SPEC))
    bound = J_programs.BoundModel(params=weights[0], first=first, step=step)
    kw = dict(CFG, display_mode="Half-SBS")
    jprog = J_programs.BatchedProgramCache(J_programs.ProgramConfig(**kw), bound, JSpec(**SPEC),
                                           compute_dtype=jnp.float32, num_streams=2)
    tprog = T_programs.BatchedProgramCache(T_programs.ProgramConfig(**kw), weights[1],
                                           TSpec(**SPEC), compute_dtype=torch.float32,
                                           num_streams=2)
    feeds = (_frames(4), [np.ascontiguousarray(f[:, ::-1]) for f in _frames(4)])
    rows = [feeds[0][0], feeds[1][0]]
    key = (2, 180, 320)
    for t, fresh in enumerate((None, [True, False], [True, True], [False, True])):
        for s in range(2):
            if fresh is None or fresh[s]:
                rows[s] = feeds[s][t]
        before = None if fresh is None else [c.clone() for c in tprog._states[key].model]
        ema = None if fresh is None else tprog._states[key].ema_depth.clone()
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(np.stack(rows)), fresh=fresh))
        t_sbs, t_depth = (a.numpy() for a in tprog(np.stack(rows), fresh=fresh))
        for s in range(2):
            _assert_frames_match(j_sbs[s], j_depth[s], t_sbs[s], t_depth[s])
        carry = tprog._states[key].model
        assert all(c.shape[0] == 2 and c.shape[2] == 31 for c in carry)
        _assert_carry_matches(tprog._states[key], jprog._states[key])
        for s in range(2):
            if fresh is not None and not fresh[s]:
                assert all(torch.equal(c[s], b[s]) for c, b in zip(carry, before))
                assert not torch.equal(tprog._states[key].ema_depth[s], ema[s])
            elif fresh is not None:
                assert not all(torch.equal(c[s], b[s]) for c, b in zip(carry, before))

