"""The port's DPT-BEiT (`models/beit.py`) against the JAX package's, on the
CPU in f32: the relative-position index and biases (on the pretraining
window and interpolated off it), the converter, the model, its int8 form,
and the streaming carry through `ProgramCache`.  The port carries each
layer's interpolated [H, R] table where JAX carries the dense [H, N, N]
bias; expanded through the index map, the tables equal JAX's biases.

Both sides take one synthetic checkpoint in the Hugging Face naming
(`torch_classic_dpt.py`) through their own converters, with a tiny preset
(pretraining window 4) registered in both packages' BEIT_PRESETS, as the
JAX parity test registers its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.models.beit as J_beit
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models import convert_hf as J_convert
import desktop2stereo_tpu_torch.models.beit as T_beit
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, quantize_state_dict
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from torch_classic_dpt import (  # noqa: F401
    CFG, F32_TOL, FUSION, INT8_TOL, NECK, _assert_frames_match, _frames, assert_trees_equal,
    hf_beit_dpt, jax_kernels, pixels, port_depth, rel)
from torch_threads import one_torch_thread  # noqa: F401

PRESET = "beit-tiny-test"
WINDOW, LAYERS, HEADS = 4, 4, 4
SPEC = dict(name=PRESET, family="dpt_beit", variant="vitb", hf_repo="none", patch_size=16,
            norm_family="half")


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    preset = (64, LAYERS, HEADS, 128, (0, 1, 2, 3), WINDOW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_beit.BEIT_PRESETS, PRESET, preset)
        mp.setitem(T_beit.BEIT_PRESETS, PRESET, preset)
        yield


@pytest.fixture(scope="module")
def beit(tiny_preset):
    """(JAX params, port DPTBEiT) from one synthetic checkpoint."""
    sd = hf_beit_dpt(seed=21)
    model = T_beit.DPTBEiT(PRESET, NECK, FUSION).eval()
    model.load_state_dict(from_flax(T_convert.convert_dpt_beit(sd, TSpec(**SPEC))), strict=True)
    return {"params": J_convert.convert_dpt_beit(sd, JSpec(**SPEC))}, model


def _jmodel(quant=False):
    return J_beit.DPTBEiT(preset=PRESET, neck_channels=NECK, fusion_channels=FUSION,
                          quant=quant)


@pytest.mark.parametrize("grid", [(4, 4), (3, 6), (18, 32), (1, 1), (5, 2)])
def test_relative_position_index_equals_jax(grid):
    got = T_beit._relative_position_index(*grid)
    want = J_beit._relative_position_index(*grid)
    assert got.dtype == want.dtype and got.shape == ((grid[0] * grid[1] + 1) ** 2,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", [(4, 4), (3, 6), (6, 6), (2, 5)],
                         ids=["pretrain-window", "3x6", "6x6", "2x5"])
def test_compute_rel_pos_biases_equals_jax(beit, grid):
    """Every layer's [H, R] table, expanded through the index map, equals
    JAX's dense bias for the grid."""
    params, model = beit
    want = J_beit.compute_rel_pos_biases(params["params"]["backbone"], *grid, WINDOW,
                                         LAYERS, HEADS)
    with torch.no_grad():
        got = T_beit.compute_rel_pos_tables(model.backbone, *grid)
    n = grid[0] * grid[1] + 1
    R = (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3
    assert len(got) == len(want) == LAYERS
    for g, w in zip(got, want):
        assert g.shape == (HEADS, R) and g.is_contiguous()
        dense = T_beit.expand_rel_pos(g, *grid)
        assert dense.shape == w.shape == (HEADS, n, n) and dense.is_contiguous()
        assert rel(dense.numpy(), w) < F32_TOL


def test_rel_pos_bias_keeps_the_table_dtype(beit):
    table = beit[1].backbone.layer[0].relative_position_bias.relative_position_bias_table
    for dtype in (torch.bfloat16, torch.float32):
        with torch.no_grad():
            for grid in ((4, 4), (3, 6)):
                bias = T_beit.build_rel_pos_bias(table.to(dtype), *grid, WINDOW, HEADS)
                assert bias.dtype == dtype and bias.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", [(4, 4), (3, 6), (18, 32)], ids=["pretrain-window", "3x6",
                                                                  "18x32"])
def test_rel_pos_table_is_the_dense_bias_gathered(beit, grid, dtype):
    """The carried table keeps the parameter's dtype, is [H, R] contiguous
    (what the kernel's table entry takes), and its expansion is
    `build_rel_pos_bias` exactly."""
    table = beit[1].backbone.layer[1].relative_position_bias.relative_position_bias_table
    with torch.no_grad():
        t = T_beit.interpolate_rel_pos_table(table.to(dtype), *grid, WINDOW, HEADS)
        dense = T_beit.build_rel_pos_bias(table.to(dtype), *grid, WINDOW, HEADS)
    R = (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3
    assert t.shape == (HEADS, R) and t.dtype == dtype and t.is_contiguous()
    assert torch.equal(T_beit.expand_rel_pos(t, *grid), dense)


@pytest.mark.parametrize("grid", [(4, 4), (3, 6)], ids=["pretrain-window", "3x6"])
def test_layer_attention_takes_the_table(beit, grid, monkeypatch):
    """A layer hands the attention its [H, R] table and the grid, never a
    dense bias, with or without a carried table."""
    layer = beit[1].backbone.layer[0]
    seen = []
    attend = T_beit.multi_head_attention

    def spy(q, k, v, bias=None, rel_pos=None):
        seen.append((bias, rel_pos))
        return attend(q, k, v, bias=bias, rel_pos=rel_pos)

    monkeypatch.setattr(T_beit, "multi_head_attention", spy)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, grid[0] * grid[1] + 1, 64)).astype(np.float32))
    with torch.no_grad():
        table = T_beit.compute_rel_pos_tables(beit[1].backbone, *grid)[0]
        out_carried = layer(x, *grid, table)
        out_own = layer(x, *grid)
    assert torch.equal(out_carried, out_own) and len(seen) == 2
    for bias, rel_pos in seen:
        assert bias is None and rel_pos[1:] == grid
        assert rel_pos[0].shape == (HEADS, (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3)


def test_converter_gives_the_jax_tree():
    sd = hf_beit_dpt(seed=22)
    tree = T_convert.convert_dpt_beit(sd, TSpec(**SPEC))
    assert_trees_equal(tree, J_convert.convert_dpt_beit(sd, JSpec(**SPEC)))
    assert set(tree["backbone"]["layer_0"]["key"]) == {"kernel"}  # k has no bias


@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (48, 80)],
                         ids=["pretrain-window", "6x6", "3x5"])
def test_dpt_beit_matches_jax(beit, hw):
    params, model = beit
    x = pixels(23, *hw)
    want = np.asarray(_jmodel().apply(params, jnp.asarray(x)))
    got = port_depth(model, x)
    assert got.shape == want.shape
    assert rel(got, want) < F32_TOL


def test_first_and_step_carry_the_biases_as_jax(beit):
    """`first` builds every layer's [H, R] table once and returns them as the
    carry; `step` takes them and hands the same tensors back; the frames
    equal JAX's stream functions and the plain forward, and the tables,
    expanded through the index map, JAX's carried dense biases."""
    params, model = beit
    first, step = J_beit.make_beit_stream_fns(_jmodel(), JSpec(**SPEC), PRESET)
    x0, x1 = pixels(24, 48, 96), pixels(25, 48, 96)
    jd0, jcarry = first(params, jnp.asarray(x0))
    jd1, _ = step(params, jnp.asarray(x1), jcarry)
    with torch.no_grad():
        td0, carry = model.first(torch.from_numpy(x0))
        td1, carry1 = model.step(torch.from_numpy(x1), carry)
        plain = model(torch.from_numpy(x1))
    assert rel(td0.numpy(), jd0) < F32_TOL and rel(td1.numpy(), jd1) < F32_TOL
    assert torch.equal(td1, plain)
    assert len(carry) == len(jcarry) == LAYERS and carry1 is carry
    for c, jc in zip(carry, jcarry):
        assert c.shape == (HEADS, 5 * 11 + 3) and c.is_contiguous()  # the 3x6 grid's R
        dense = T_beit.expand_rel_pos(c, 3, 6)
        assert dense.shape == (HEADS, 19, 19) and rel(dense.numpy(), jc) < F32_TOL


def test_int8_matches_jax(beit):
    """query, key (no bias), value, proj, fc1 and fc2 of every layer int8:
    the port's quantisation equals the JAX tree's, weight and scale, and
    the int8 models agree."""
    params, model = beit
    qtree = jax.tree.map(np.asarray, J_quant.quantize_tree(params))
    state = quantize_state_dict(model.state_dict())
    want = from_flax(qtree)
    assert set(state) == set(want)
    quantized = [k[: -len(".weight_q")] for k in want if k.endswith(".weight_q")]
    assert len(quantized) == 6 * LAYERS
    for k in quantized:
        assert torch.equal(state[k + ".weight_q"], want[k + ".weight_q"]), k
        assert torch.equal(state[k + ".scale"], want[k + ".scale"]), k
    assert "backbone.layer.0.key.bias" not in state
    qmodel = T_beit.DPTBEiT(PRESET, NECK, FUSION, quant=True).eval()
    qmodel.load_state_dict(state, strict=True)
    assert sum(isinstance(m, QuantLinear) for m in qmodel.modules()) == 6 * LAYERS
    x = pixels(26, 48, 80)
    jm = _jmodel(quant=True)
    want_d = np.asarray(jax.jit(lambda p, a: jm.apply(p, a))(qtree, jnp.asarray(x)))
    assert rel(port_depth(qmodel, x), want_d) < INT8_TOL


# ---- the frame program -------------------------------------------------------------------------

class _CountTables:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def test_program_cache_streams_the_biases_like_jax(beit, jax_kernels, monkeypatch):  # noqa: F811
    """first → step → step on 180x320 frames (a 48x96 input, grid 3x6, off
    the window), switched live from Half-SBS to Half-TAB after the first;
    then a 180x240 capture (another output size): a carry of its own.  The
    frames against JAX's ProgramCache; the tables built once per stream and
    size, the carry surviving the switch and, expanded, equal to JAX's
    dense biases."""
    params, model = beit
    counter = _CountTables(T_beit.compute_rel_pos_tables)
    monkeypatch.setattr(T_beit, "compute_rel_pos_tables", counter)
    first, step = J_beit.make_beit_stream_fns(_jmodel(), JSpec(**SPEC), PRESET)
    cfg = dict(CFG, model_name=PRESET, display_mode="Half-SBS")
    jprog = J_programs.ProgramCache(J_programs.ProgramConfig(**cfg),
                                    J_programs.BoundModel(params=params, first=first, step=step),
                                    JSpec(**SPEC), compute_dtype=jnp.float32)
    tprog = T_programs.ProgramCache(T_programs.ProgramConfig(**cfg), model, TSpec(**SPEC),
                                    compute_dtype=torch.float32)
    key = (0, 180, 320)
    kept = None
    frames = _frames(3)
    for i, frame in enumerate(frames + [frames[2][:, :240]]):
        if i == 1:
            jprog.set_display_mode("Half-TAB")
            tprog.set_display_mode("Half-TAB")
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
        if i < 3:
            carry = tprog._states[key].model
            assert kept is None or all(a is b for a, b in zip(carry, kept))
            kept = carry
            for c, jc in zip(carry, jprog._states[key].model):
                assert c.shape == (HEADS, 58)
                assert rel(T_beit.expand_rel_pos(c, 3, 6).numpy(), jc) < F32_TOL
            assert counter.calls == 1
    assert counter.calls == 2 and set(tprog._states) == {key, (0, 180, 240)}
    mh, mw = T_programs.ema_shape(tprog.cfg, tprog.spec, 180, 240)
    gh, gw = mh // 16, mw // 16
    other = tprog._states[(0, 180, 240)].model
    assert other[0].shape == (HEADS, (2 * gh - 1) * (2 * gw - 1) + 3) and (gh, gw) != (3, 6)
    for c, jc in zip(other, jprog._states[(0, 180, 240)].model):
        assert rel(T_beit.expand_rel_pos(c, gh, gw).numpy(), jc) < F32_TOL
    assert tprog._states[key].model is kept


def test_warmup_keeps_no_carry(beit):
    tprog = T_programs.ProgramCache(
        T_programs.ProgramConfig(**dict(CFG, model_name=PRESET, display_mode="Half-SBS")),
        beit[1], TSpec(**SPEC), compute_dtype=torch.float32)
    report = tprog.warmup((180, 320, 4))
    assert set(report) == {"pre_s", "model_s", "tail_s"} and not tprog._states


def test_build_bound_runs_dpt_beit_base_float_and_int8(monkeypatch):
    """dpt-beit-base-384 at its real widths, seeded, on the CPU: stateful
    (first, then step with the carried tables), its unit-normal tables
    drawn from the seed, int8 on 6 products a layer."""
    import desktop2stereo_tpu_torch.models.factory as factory

    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", ())
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    x = torch.from_numpy(pixels(36, 64, 96))
    for quant, want in (("none", 0), ("int8", 72)):
        model, _ = factory.build_bound("dpt-beit-base-384", device="cpu", quant=quant)
        assert sum(isinstance(m, QuantLinear) for m in model.modules()) == want
        table = model.backbone.layer[0].relative_position_bias.relative_position_bias_table
        assert 0.9 < table.std().item() < 1.1
        with torch.no_grad():
            d0, carry = model.first(x)
            d1, carry1 = model.step(x, carry)
        assert carry1 is carry and len(carry) == 12 and carry[0].shape == (12, 7 * 11 + 3)
        assert d0.shape == (1, 64, 96) and torch.equal(d0, d1)


def _stale_steps(tprog, per_stream):
    """Two streams, batched, over three steps with the second row stale on
    step 2 (fresh=[True, False]), against `per_stream(frame, s)`, a JAX
    per-stream ProgramCache fed each row's frames (a stale row its frame
    again: its EMA advances, as the batched row's does).  Each row within
    the pipeline test's thresholds; the carry is the first step's tables,
    never masked.  → the carry."""
    feeds = (_frames(3), [np.ascontiguousarray(f[:, ::-1]) for f in _frames(3)])
    rows = [feeds[0][0], feeds[1][0]]
    kept = None
    for t, fresh in enumerate((None, [True, False], [True, True])):
        for s in range(2):
            if fresh is None or fresh[s]:
                rows[s] = feeds[s][t]
        t_sbs, t_depth = (a.numpy() for a in tprog(np.stack(rows), fresh=fresh))
        for s in range(2):
            j_sbs, j_depth = (np.asarray(a) for a in per_stream(rows[s], s))
            _assert_frames_match(j_sbs, j_depth, t_sbs[s], t_depth[s])
        carry = tprog._states[(2, 180, 320)].model
        assert kept is None or carry is kept
        kept = carry
    return kept


def test_batched_program_carries_one_set_of_tables_past_a_stale_row(beit, jax_kernels):  # noqa: F811
    """The batched BEiT takes a stale row (where JAX's batched cache raises,
    ROADMAP C9, next test) and carries one set of [H, R] tables for the
    batch, equal (expanded) to a JAX stream's dense biases."""
    params, model = beit
    first, step = J_beit.make_beit_stream_fns(_jmodel(), JSpec(**SPEC), PRESET)
    cfg = dict(CFG, model_name=PRESET, display_mode="Half-SBS")
    jprog = J_programs.ProgramCache(J_programs.ProgramConfig(**cfg),
                                    J_programs.BoundModel(params=params, first=first, step=step),
                                    JSpec(**SPEC), compute_dtype=jnp.float32)
    tprog = T_programs.BatchedProgramCache(T_programs.ProgramConfig(**cfg), model, TSpec(**SPEC),
                                           compute_dtype=torch.float32, num_streams=2)
    carry = _stale_steps(tprog, lambda frame, s: jprog(jnp.asarray(frame), stream=s))
    assert len(carry) == LAYERS and all(c.shape == (HEADS, 58) for c in carry)
    for c, jc in zip(carry, jprog._states[(0, 180, 320)].model):
        assert rel(T_beit.expand_rel_pos(c, 3, 6).numpy(), jc) < F32_TOL


def test_jax_batched_cache_cannot_take_a_stale_row(beit):
    """ROADMAP C9: the JAX BatchedProgramCache masks every leaf of the carry
    with the [S] `fresh` mask, and BEiT's per-shape [H, N, N] biases have no
    stream axis, so its second step with a stale row raises."""
    params, _ = beit
    first, step = J_beit.make_beit_stream_fns(_jmodel(), JSpec(**SPEC), PRESET)
    cfg = dict(CFG, model_name=PRESET, display_mode="Half-SBS", quality="fast")
    jprog = J_programs.BatchedProgramCache(
        J_programs.ProgramConfig(**cfg), J_programs.BoundModel(params=params, first=first,
                                                               step=step),
        JSpec(**SPEC), compute_dtype=jnp.float32, num_streams=2)
    frames = jnp.asarray(np.stack([_frames(1)[0]] * 2))
    jprog(frames)  # the first step builds the carry
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jprog(frames, fresh=np.array([True, False]))

