"""The port's registry and Depth-Anything model against the JAX package's.

A tiny DepthAnything is initialised by the JAX package (`jit_init`, seeded),
its parameter tree moved over with `from_flax`, and both run the same numpy
input on the CPU in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desktop2stereo_tpu.core import registry as J_reg
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu.models.dinov2 import Dinov2Encoder as JEncoder
from desktop2stereo_tpu.models.init_util import jit_init
from desktop2stereo_tpu_torch.core import registry as T_reg
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder
from desktop2stereo_tpu_torch.models.factory import build_bound
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(hidden_size=64, num_layers=4, num_heads=2, mlp_dim=128,
            out_layers=(0, 1, 2, 3), neck_channels=(16, 32, 64, 64),
            fusion_channels=32)
REL_TOL = 5e-4  # f32 parity, as tests/test_models_depth_anything.py


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def test_registry_entries_equal_jax():
    """Every one of the JAX registry's 52 names, with equal specs (menus,
    square-only, normalisation, patch size, metric-ness)."""
    port = T_reg.MODEL_REGISTRY
    jax_all = J_reg.MODEL_REGISTRY
    assert set(port) == set(jax_all) and len(port) == 52
    for name, spec in port.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jax_all[name]), name
        assert spec.dims == jax_all[name].dims
        if spec.variant in T_reg.DPT_LAYER_IDS:  # not InfiniDepth-SmallPlus's "vitsplus"
            assert (spec.dpt_layers, spec.neck_channels, spec.fusion_channels) == (
                jax_all[name].dpt_layers, jax_all[name].neck_channels,
                jax_all[name].fusion_channels)
    assert T_reg.VIT_VARIANTS == J_reg.VIT_VARIANTS
    assert T_reg.DPT_LAYER_IDS == J_reg.DPT_LAYER_IDS
    assert T_reg.NECK_CHANNELS == J_reg.NECK_CHANNELS
    assert T_reg.FUSION_CHANNELS == J_reg.FUSION_CHANNELS


def test_registry_refuses_unported_families():
    """Every family is ported: a name outside the JAX registry raises, and
    every registry name has a builder."""
    from desktop2stereo_tpu_torch.models.factory import FAMILIES

    with pytest.raises(KeyError, match="unknown model 'zoedepth-foo'"):
        T_reg.get_spec("zoedepth-foo")
    assert {s.family for s in T_reg.MODEL_REGISTRY.values()} == set(FAMILIES)


@pytest.fixture(scope="module")
def tiny_params():
    """One seeded JAX init of the tiny model, shared by the tests below
    (its jit compile dominates this file's run time)."""
    params = jit_init(JDepthAnything(**TINY), jnp.zeros((1, 28, 42, 3), jnp.float32),
                      rng_seed=0)
    return jax.tree.map(np.asarray, params)


def _run_both(jmodel, tmodel, params, x):
    tmodel.load_state_dict(from_flax(params), strict=True)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x))
    return got, want


@pytest.mark.parametrize("hw", [(70, 126), (42, 42)])
def test_tiny_depth_anything_matches_jax(tiny_params, hw):
    """Whole model: patch embed, pos-embed interpolation (the grids differ
    from the 37×37 table), encoder, DPT neck and head."""
    x = np.random.default_rng(7).standard_normal((1, *hw, 3)).astype(np.float32)
    got, want = _run_both(JDepthAnything(**TINY), DepthAnything(**TINY), tiny_params, x)
    assert got.shape == want.shape == (1, *hw)
    assert _rel(got.numpy(), want) < REL_TOL


def test_metric_head_matches_jax(tiny_params):
    kw = dict(TINY, metric=True, max_depth=20.0)
    x = np.random.default_rng(8).standard_normal((1, 56, 84, 3)).astype(np.float32)
    got, want = _run_both(JDepthAnything(**kw), DepthAnything(**kw), tiny_params, x)
    assert _rel(got.numpy(), want) < REL_TOL


def test_encoder_skips_trailing_layers_like_jax(tiny_params):
    """Layers after the last selected output feed nothing and are not built."""
    kw = dict(hidden_size=64, num_layers=6, num_heads=2, mlp_dim=128, out_layers=(0, 2))
    tm = Dinov2Encoder(**kw)
    assert len(tm.layer) == 3
    backbone = {k: v for k, v in tiny_params["params"]["backbone"].items() if k != "layer_3"}
    x = np.random.default_rng(9).standard_normal((2, 28, 42, 3)).astype(np.float32)
    got, want = _run_both(JEncoder(**kw), tm, {"params": backbone}, x)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < REL_TOL


def test_from_flax_layouts(tiny_params):
    """Dense [in,out] → [out,in]; conv HWIO → OIHW; conv-transpose kept."""
    params = tiny_params["params"]
    sd = from_flax(tiny_params)
    qkv = params["backbone"]["layer_2"]["attention"]["qkv"]["kernel"]
    np.testing.assert_array_equal(sd["backbone.layer.2.attention.qkv.weight"].numpy(), qkv.T)
    conv = params["neck"]["fusion_1"]["res1"]["conv2"]["kernel"]
    np.testing.assert_array_equal(sd["neck.fusion.1.res1.conv2.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    convt = params["neck"]["reassemble_0"]["resize"]["kernel"]
    np.testing.assert_array_equal(sd["neck.reassemble.0.resize.weight"].numpy(), convt)
    ln = params["backbone"]["layernorm"]["scale"]
    np.testing.assert_array_equal(sd["backbone.layernorm.weight"].numpy(), ln)
    assert set(sd) == set(DepthAnything(**TINY).state_dict())


def test_build_bound_is_seeded_and_finite():
    a, spec = build_bound("Depth-Anything-V2-Small", device="cpu", seed=0)
    b, _ = build_bound("Depth-Anything-V2-Small", device="cpu", seed=0)
    c, _ = build_bound("Depth-Anything-V2-Small", device="cpu", seed=1)
    assert next(a.parameters()).dtype == torch.float32
    assert spec.variant == "vits" and not a.training
    w = "backbone.layer.3.mlp.fc1.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 42, 70, 3)).astype(np.float32))
    with torch.no_grad():
        y = a(x)
    assert y.shape == (1, 42, 70) and torch.isfinite(y).all()


def test_build_bound_defaults_to_the_card():
    """No device means the CUDA policy's device: without CUDA that raises
    instead of quietly building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the host without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_bound("Depth-Anything-V2-Small")
