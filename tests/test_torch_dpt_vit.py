"""The port's classic DPT (`models/dpt_vit.py`: DPTViT, the readout decoder,
DPTDinov2) against the JAX package's, on the CPU in f32.

Both sides take one synthetic checkpoint in the Hugging Face naming
(`torch_classic_dpt.py`), each through its own converter; the port's tree
goes through `from_flax`.  Tiny widths, registered in both packages'
presets as the JAX parity tests register theirs.  DPT-DINOv2 with the
SwiGLU MLP (its ViT-G form) is held against the JAX `Dinov2Encoder` with
`use_swiglu=True` under the JAX classic decoder: the JAX `DPTDinov2` builds
every variant with the plain MLP (ROADMAP C6).
"""

from typing import Sequence

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.models.dpt_vit as J_dpt
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models import convert_hf as J_convert
from desktop2stereo_tpu.models.dinov2 import Dinov2Encoder as JDinov2Encoder
import desktop2stereo_tpu_torch.models.dpt_vit as T_dpt
from desktop2stereo_tpu_torch.core.registry import MODEL_REGISTRY, ModelSpec as TSpec
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models.factory import build_bound
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, quantize_state_dict
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from torch_classic_dpt import (  # noqa: F401
    CFG, F32_TOL, FUSION, INT8_TOL, NECK, _assert_frames_match, _frames, assert_trees_equal,
    hf_dinov2_dpt, hf_dpt_vit, jax_kernels, pixels, port_depth, rel)
from torch_threads import one_torch_thread  # noqa: F401

VIT = dict(hidden_size=64, num_layers=4, num_heads=4, mlp_dim=128, out_indices=(0, 1, 2, 3),
           neck_channels=NECK, fusion_channels=FUSION, patch_size=16, pretrain_grid=4)
DINO = dict(hidden_size=64, num_layers=4, num_heads=4, mlp_dim=128, neck_channels=NECK,
            fusion_channels=FUSION, patch_size=14)


class _Spec:
    """What the converters read of a spec."""

    def __init__(self, variant, dims=(64, 4, 4, 128)):
        self.variant, self.dims = variant, dims


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    """A tiny "tiny" DPT_VIT_PRESETS entry in both packages."""
    preset = (64, 4, 4, 128, (0, 1, 2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_dpt.DPT_VIT_PRESETS, "tiny", preset)
        mp.setitem(T_dpt.DPT_VIT_PRESETS, "tiny", preset)
        yield


class JDPTDinov2SwiGLU(fnn.Module):
    """The JAX DPTDinov2 with its trunk's SwiGLU MLP switched on."""

    neck_channels: Sequence[int] = NECK
    fusion_channels: int = FUSION

    @fnn.compact
    def __call__(self, x):
        gh, gw = x.shape[1] // 14, x.shape[2] // 14
        feats = JDinov2Encoder(hidden_size=64, num_layers=4, num_heads=4, mlp_dim=128,
                               out_layers=(0, 1, 2, 3), use_swiglu=True,
                               name="backbone")(x)
        return J_dpt.ClassicDPTDecoder(hidden_size=64, neck_channels=self.neck_channels,
                                       fusion_channels=self.fusion_channels,
                                       name="decoder")(list(feats), gh, gw)


def _jax_dinov2_tree(sd, swiglu):
    if swiglu:  # the JAX converter's pieces, with the SwiGLU trunk
        return {"backbone": J_convert.convert_dinov2_backbone(sd, 4, use_swiglu=True,
                                                              prefix="backbone."),
                "decoder": J_convert.convert_classic_dpt_decoder(sd)}
    return J_convert.convert_dpt_dinov2(sd, _Spec("vits"))


def _jax_dinov2(swiglu):
    return JDPTDinov2SwiGLU() if swiglu else J_dpt.DPTDinov2(**DINO)


def _port_dinov2(sd, swiglu):
    model = T_dpt.DPTDinov2(**DINO, use_swiglu=swiglu).eval()
    tree = T_convert.convert_dpt_dinov2(sd, _Spec("vitg" if swiglu else "vits"))
    model.load_state_dict(from_flax(tree), strict=True)
    return model, tree


@pytest.fixture(scope="module")
def vit():
    """(JAX params, port DPTViT) from one synthetic dpt-large-style checkpoint."""
    sd = hf_dpt_vit(seed=1)
    model = T_dpt.DPTViT(**VIT).eval()
    model.load_state_dict(from_flax(T_convert.convert_dpt_vit(sd, _Spec("tiny"))), strict=True)
    return {"params": J_convert.convert_dpt_vit(sd, _Spec("tiny"))}, model


# ---- converters ----------------------------------------------------------------------------

def test_dpt_vit_converter_gives_the_jax_tree():
    sd = hf_dpt_vit(seed=2)
    assert_trees_equal(T_convert.convert_dpt_vit(sd, _Spec("tiny")),
                       J_convert.convert_dpt_vit(sd, _Spec("tiny")))


@pytest.mark.parametrize("swiglu", [False, True], ids=["mlp", "swiglu"])
def test_dpt_dinov2_converter_gives_the_jax_tree(swiglu):
    sd = hf_dinov2_dpt(seed=3, swiglu=swiglu)
    _, tree = _port_dinov2(sd, swiglu)
    assert_trees_equal(tree, _jax_dinov2_tree(sd, swiglu))
    mlp = tree["backbone"]["layer_0"]["mlp"]
    assert set(mlp) == ({"weights_in", "weights_out"} if swiglu else {"fc1", "fc2"})


def test_classic_decoder_converter_gives_the_jax_tree():
    sd = hf_dpt_vit(seed=4)
    assert_trees_equal(T_convert.convert_classic_dpt_decoder(sd),
                       J_convert.convert_classic_dpt_decoder(sd))


# ---- models ----------------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 64), (80, 112)], ids=["pretrain-grid", "interpolated"])
def test_dpt_vit_matches_jax(vit, hw):
    """4x4 is the tiny table's own grid; 5x7 resizes the position table."""
    params, model = vit
    x = pixels(5, *hw)
    want = np.asarray(J_dpt.DPTViT(**VIT).apply(params, jnp.asarray(x)))
    got = port_depth(model, x)
    assert got.shape == want.shape
    assert rel(got, want) < F32_TOL


def test_classic_decoder_aux_matches_jax(vit):
    """`return_aux`: the fusion pyramid, the bottleneck and the mid
    features, as ZoeDepth reads them."""
    params, model = vit
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((1, 1 + 3 * 5, 64)).astype(np.float32) for _ in range(4)]
    dec = J_dpt.ClassicDPTDecoder(hidden_size=64, neck_channels=NECK, fusion_channels=FUSION)
    jd, jaux = dec.apply({"params": params["params"]["decoder"]},
                         [jnp.asarray(f) for f in feats], 3, 5, return_aux=True)
    with torch.no_grad():
        td, taux = model.decoder([torch.from_numpy(f) for f in feats], 3, 5, return_aux=True)
    assert rel(td.numpy(), jd) < F32_TOL
    assert len(taux["fusion"]) == len(jaux["fusion"]) == 4
    for t, j in zip(taux["fusion"] + [taux["bottleneck"], taux["features"]],
                    jaux["fusion"] + [jaux["bottleneck"], jaux["features"]]):
        assert t.shape == j.shape
        assert rel(t.numpy(), j) < F32_TOL


@pytest.mark.parametrize("swiglu", [False, True], ids=["mlp", "swiglu"])
@pytest.mark.parametrize("hw", [(70, 70), (56, 84)])
def test_dpt_dinov2_matches_jax(hw, swiglu):
    sd = hf_dinov2_dpt(seed=7, swiglu=swiglu)
    model, _ = _port_dinov2(sd, swiglu)
    x = pixels(8, *hw)
    want = np.asarray(_jax_dinov2(swiglu).apply({"params": _jax_dinov2_tree(sd, swiglu)},
                                                jnp.asarray(x)))
    got = port_depth(model, x)
    assert got.shape == want.shape
    assert rel(got, want) < F32_TOL


@pytest.mark.parametrize("grid", [(9, 16), (14, 24), (18, 32), (3, 6), (21, 37), (7, 5)])
def test_head_resolution_matches_jax(vit, grid):
    """The depth comes back at the head's resolution, 32·⌈g/2⌉ a side, on
    the patch-16 menu's 4K grids (256 → 9x16, 384 → 14x24, 512 → 18x32),
    DINOv2's 518 grid and odd ones; the frame program resizes it as JAX."""
    params, model = vit
    x = pixels(9, 16 * grid[0], 16 * grid[1])
    want = jax.eval_shape(J_dpt.DPTViT(**VIT).apply, params, jnp.asarray(x))
    got = port_depth(model, x)
    assert got.shape == want.shape == (1, 32 * -(-grid[0] // 2), 32 * -(-grid[1] // 2))


# ---- int8 ------------------------------------------------------------------------------------

def _jitted(module, params, x):
    return np.asarray(jax.jit(lambda p, a: module.apply(p, a))(params, jnp.asarray(x)))


def _assert_int8_state_equal(port_state, jax_qtree):
    """Every int8 weight and scale of the port's own quantisation equals
    the JAX tree's, carried over by from_flax."""
    want = from_flax(jax_qtree)
    quantized = [k for k in want if k.endswith(".weight_q")]
    assert quantized and set(port_state) == set(want)
    for k in quantized:
        scale = k[: -len("weight_q")] + "scale"
        assert torch.equal(port_state[k], want[k]), k
        assert torch.equal(port_state[scale], want[scale]), scale


def test_dpt_vit_int8_matches_jax(vit):
    """The ViT layers quantized (the JAX builder's `layer_{i}` scopes, the
    port's "layer"), the embedding and the decoder float."""
    params, model = vit
    qtree = jax.tree.map(np.asarray, J_quant.quantize_tree(
        params, scope=tuple(f"layer_{i}" for i in range(4))))
    state = quantize_state_dict(model.state_dict(), ("layer",))
    _assert_int8_state_equal(state, qtree)
    qmodel = T_dpt.DPTViT(**VIT, quant=True).eval()
    qmodel.load_state_dict(state, strict=True)
    assert sum(isinstance(m, QuantLinear) for m in qmodel.modules()) == 16
    x = pixels(10, 64, 80)
    want = _jitted(J_dpt.DPTViT(**VIT, quant=True), qtree, x)
    assert rel(port_depth(qmodel, x), want) < INT8_TOL


def test_dpt_dinov2_int8_matches_jax():
    sd = hf_dinov2_dpt(seed=11)
    model, tree = _port_dinov2(sd, False)
    qtree = jax.tree.map(np.asarray, J_quant.quantize_tree({"params": tree}))
    state = quantize_state_dict(model.state_dict())
    _assert_int8_state_equal(state, qtree)
    qmodel = T_dpt.DPTDinov2(**DINO, quant=True).eval()
    qmodel.load_state_dict(state, strict=True)
    x = pixels(12, 56, 70)
    want = _jitted(J_dpt.DPTDinov2(**DINO, quant=True), qtree, x)
    assert rel(port_depth(qmodel, x), want) < INT8_TOL


@pytest.mark.parametrize("name", ["dpt-dinov2-small-kitti", "dpt-dinov2-base-nyu"])
def test_quant_none_is_float_for_dpt_dinov2(name, monkeypatch):
    """`quant="none"` builds no int8 product (the JAX `build_model` hands
    the string to `build_dpt_dinov2`, which quantizes on any non-empty
    one: ROADMAP C5); "int8" quantizes the 4 products of every layer."""
    import desktop2stereo_tpu_torch.models.factory as factory

    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", ())
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    spec = MODEL_REGISTRY[name]
    x = torch.from_numpy(pixels(13, 28, 42))
    for quant, want in (("none", 0), ("int8", 4 * spec.dims[1])):
        model, _ = build_bound(name, device="cpu", quant=quant)
        assert sum(isinstance(m, QuantLinear) for m in model.modules()) == want
        with torch.no_grad():
            depth = model(x)
        assert depth.shape == (1, 32, 64) and bool(torch.isfinite(depth).all())


# ---- the frame program -------------------------------------------------------------------------

def _spec(pkg_spec, name, family, variant, patch):
    return pkg_spec(name=name, family=family, variant=variant, hf_repo="none",
                    patch_size=patch, metric=family == "dpt_dinov2", norm_family="half")


@pytest.mark.parametrize("family", ["dpt", "dpt_dinov2"])
def test_program_cache_matches_jax(vit, jax_kernels, family):  # noqa: F811
    """Two 180x320 frames at depth resolution 96 through both ProgramCaches
    (Half-SBS): the patch-16 grid is 3x6, so the head's 64x96 depth differs
    from the 48x96 model input and the EMA carry takes the head's shape
    from frame 1 on, as in JAX."""
    if family == "dpt":
        params, model = vit
        jmodel, patch = J_dpt.DPTViT(**VIT), 16
    else:
        sd = hf_dinov2_dpt(seed=14)
        model, tree = _port_dinov2(sd, False)
        params, jmodel, patch = {"params": tree}, J_dpt.DPTDinov2(**DINO), 14
    name = f"{family}-test"
    cfg = dict(CFG, model_name=name, display_mode="Half-SBS")
    jprog = J_programs.ProgramCache(
        J_programs.ProgramConfig(**cfg), J_programs.BoundModel.stateless(jmodel.apply, params),
        _spec(JSpec, name, family, "vits", patch), compute_dtype=jnp.float32)
    tprog = T_programs.ProgramCache(T_programs.ProgramConfig(**cfg), model,
                                    _spec(TSpec, name, family, "vits", patch),
                                    compute_dtype=torch.float32)
    for frame in _frames(2):
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
    head = (64, 96) if family == "dpt" else (64, 128)
    assert t_depth.shape == head
    assert tprog._states[(0, 180, 320)].ema_depth.shape == head


def test_batch_of_two_equals_each_image_alone(vit):
    """The batched multi-stream program runs the model at batch S
    (`BatchedProgramCache`): each row of a batch of two equals that image
    alone, within F32_TOL."""
    _, model = vit
    x = np.concatenate([pixels(6, 80, 112), pixels(7, 80, 112)])
    got = port_depth(model, x)
    for s in range(2):
        assert rel(got[s:s + 1], port_depth(model, x[s:s + 1])) < F32_TOL
