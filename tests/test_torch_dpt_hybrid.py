"""The port's DPT-Hybrid (`models/dpt_hybrid.py`: the BiT stem under the ViT
trunk) against the JAX package's, on the CPU in f32, at the JAX parity
test's tiny configuration: the converter, TF-SAME padding of the strided
weight-standardized convs and the max pool, the model on its pretraining
grid and off it, the int8 model and one frame program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.models.dpt_hybrid as J_hyb
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models import convert_hf as J_convert
import desktop2stereo_tpu_torch.models.dpt_hybrid as T_hyb
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, quantize_state_dict
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from torch_classic_dpt import (  # noqa: F401
    CFG, F32_TOL, HYBRID, INT8_TOL, _assert_frames_match, _frames, assert_trees_equal,
    hf_dpt_hybrid, jax_kernels, pixels, port_depth, rel)
from torch_threads import one_torch_thread  # noqa: F401

CONVERT = dict(depths=HYBRID["bit_depths"], num_layers=HYBRID["vit_layers"])
SPEC = dict(name="hybrid-test", family="dpt_hybrid", variant="vitb", hf_repo="none",
            patch_size=16, norm_family="half")


def _trees(sd):
    return (T_convert.convert_dpt_hybrid(sd, TSpec(**SPEC), **CONVERT),
            J_convert.convert_dpt_hybrid(sd, JSpec(**SPEC), **CONVERT))


@pytest.fixture(scope="module")
def hybrid():
    """(JAX params, port DPTHybrid) from one synthetic checkpoint."""
    t_tree, j_tree = _trees(hf_dpt_hybrid(seed=31))
    model = T_hyb.DPTHybrid(**HYBRID).eval()
    model.load_state_dict(from_flax(t_tree), strict=True)
    return {"params": j_tree}, model


def test_converter_gives_the_jax_tree():
    t_tree, j_tree = _trees(hf_dpt_hybrid(seed=32))
    assert_trees_equal(t_tree, j_tree)
    assert set(t_tree["readout_2"]) == {"kernel", "bias"} and "resize" in t_tree["reassemble_3"]


@pytest.mark.parametrize("k,stride,hw", [(7, 2, (33, 50)), (3, 2, (16, 17)), (1, 2, (9, 9)),
                                         (3, 1, (5, 8))])
def test_ws_conv_pads_as_tf_same(k, stride, hw):
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 6, 8)).astype(np.float32)
    want = J_hyb.WSConv(8, (k, k), (stride, stride)).apply({"params": {"kernel": kernel}},
                                                           jnp.asarray(x))
    conv = T_hyb.WSConv(6, 8, k, stride)
    conv.load_state_dict(from_flax({"kernel": kernel}), strict=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, -(-hw[0] // stride), -(-hw[1] // stride), 8)
    assert rel(got, want) < F32_TOL


@pytest.mark.parametrize("hw", [(33, 50), (64, 64), (16, 8)])
def test_stem_pool_pads_as_tf_same(hw):
    """The stem's max pool: TF-SAME over -inf padding."""
    rng = np.random.default_rng(sum(hw))
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    params = {"conv": {"kernel": rng.standard_normal((7, 7, 3, 8)).astype(np.float32)},
              "norm": {"norm": {"scale": np.ones(8, np.float32),
                                "bias": 0.1 * rng.standard_normal(8).astype(np.float32)}}}
    want = J_hyb.BitStem(8, 4).apply({"params": params}, jnp.asarray(x))
    stem = T_hyb.BitStem(8, 4)
    stem.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        got = stem(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel(got, want) < F32_TOL


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)], ids=["pretrain-grid", "interpolated"])
def test_dpt_hybrid_matches_jax(hybrid, hw):
    params, model = hybrid
    x = pixels(33, *hw)
    want = np.asarray(J_hyb.DPTHybrid(**HYBRID).apply(params, jnp.asarray(x)))
    got = port_depth(model, x)
    assert got.shape == want.shape
    assert rel(got, want) < F32_TOL


def test_int8_matches_jax(hybrid):
    """The ViT layers' products int8 (the JAX builder's `layer_{i}` scopes,
    the port's "layer"); the BiT stem, the projection and the decoder
    float."""
    params, model = hybrid
    qtree = jax.tree.map(np.asarray, J_quant.quantize_tree(
        params, scope=tuple(f"layer_{i}" for i in range(HYBRID["vit_layers"]))))
    state = quantize_state_dict(model.state_dict(), ("layer",))
    want = from_flax(qtree)
    assert set(state) == set(want)
    quantized = [k for k in want if k.endswith(".weight_q")]
    assert len(quantized) == 4 * HYBRID["vit_layers"]
    assert all(k.startswith("layer.") for k in quantized)
    for k in quantized:
        scale = k[: -len("weight_q")] + "scale"
        assert torch.equal(state[k], want[k]) and torch.equal(state[scale], want[scale]), k
    qmodel = T_hyb.DPTHybrid(**HYBRID, quant=True).eval()
    qmodel.load_state_dict(state, strict=True)
    assert sum(isinstance(m, QuantLinear) for m in qmodel.modules()) == len(quantized)
    x = pixels(34, 48, 64)
    jm = J_hyb.DPTHybrid(**HYBRID, quant=True)
    want_d = np.asarray(jax.jit(lambda p, a: jm.apply(p, a))(qtree, jnp.asarray(x)))
    assert rel(port_depth(qmodel, x), want_d) < INT8_TOL


def test_program_cache_matches_jax(hybrid, jax_kernels):  # noqa: F811
    """Two 180x320 frames at depth resolution 96 (a 48x96 input, grid 3x6:
    the head's depth is 64x96) through both ProgramCaches, Half-SBS."""
    params, model = hybrid
    cfg = dict(CFG, model_name=SPEC["name"], display_mode="Half-SBS")
    jprog = J_programs.ProgramCache(
        J_programs.ProgramConfig(**cfg),
        J_programs.BoundModel.stateless(J_hyb.DPTHybrid(**HYBRID).apply, params),
        JSpec(**SPEC), compute_dtype=jnp.float32)
    tprog = T_programs.ProgramCache(T_programs.ProgramConfig(**cfg), model, TSpec(**SPEC),
                                    compute_dtype=torch.float32)
    for frame in _frames(2):
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
    assert t_depth.shape == (64, 96)


def test_build_bound_runs_dpt_hybrid_midas_float_and_int8(monkeypatch):
    """The registry name at its real widths, seeded, on the CPU: float, and
    int8 on the 12 ViT layers' 48 products (the BiT stem stays float)."""
    import desktop2stereo_tpu_torch.models.factory as factory

    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", ())
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    x = torch.from_numpy(pixels(35, 64, 96))
    for quant, want in (("none", 0), ("int8", 48)):
        model, spec = factory.build_bound("dpt-hybrid-midas", device="cpu", quant=quant)
        assert spec.norm_family == "half" and spec.patch_size == 16
        assert sum(isinstance(m, QuantLinear) for m in model.modules()) == want
        with torch.no_grad():
            depth = model(x)
        assert depth.shape == (1, 64, 96) and bool(torch.isfinite(depth).all())


def test_batch_of_two_equals_each_image_alone(hybrid):
    """The batched multi-stream program runs the model at batch S
    (`BatchedProgramCache`): each row of a batch of two equals that image
    alone, within F32_TOL."""
    _, model = hybrid
    x = np.concatenate([pixels(34, 48, 80), pixels(35, 48, 80)])
    got = port_depth(model, x)
    for s in range(2):
        assert rel(got[s:s + 1], port_depth(model, x[s:s + 1])) < F32_TOL
