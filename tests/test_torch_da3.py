"""The port's Depth-Anything-3 (`models/da3.py`) against the JAX package's,
on the CPU in f32.

Tiny presets stand in for the registry's widths: a "tiny" entry of
`DA3_PRESETS`, and the ViT-L and ViT-G entries of `DA3_PRESETS`,
`DA3_MONO_OUT_LAYERS` and the ViT variant table, are patched to the same
small values in both packages (5 layers, hidden 64, 2 heads of 32, the
camera token, QK-norm and RoPE from layer 2, so that layer 3 attends across
views; the ViT-S entries stay real for the converter's test), and the
weights come from one seeded JAX init (`jit_init`), every
leaf then moved off flax's zeros and ones by seeded numpy noise (so that
position tables, norms, biases and layer scales are exercised), and carried
over by `from_flax`.  Inputs are seeded numpy.  Tolerances are those of
`tests/test_torch_vda.py`: REL_TOL on the max error over the max value.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.core.registry as J_reg
import desktop2stereo_tpu.models.da3 as J_da3
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
import desktop2stereo_tpu_torch.cli as T_cli
import desktop2stereo_tpu_torch.core.registry as T_reg
import desktop2stereo_tpu_torch.models.da3 as T_da3
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models import convert_hf as J_convert
from desktop2stereo_tpu.models.init_util import jit_init
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models import factory as T_factory
from desktop2stereo_tpu_torch.models import safetensors_io
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
from test_torch_pipeline import (  # noqa: F401
    _assert_frames_match, _frames, _LockstepSource, _RecordingSink, jax_kernels)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 5e-4  # f32 parity, as tests/test_torch_vda.py
# (out_layers, alt_start, neck_channels, fusion_channels) and ViT dims
TINY_PRESET = ((1, 2, 3, 4), 2, (16, 32, 64, 64), 32)
TINY_DIMS = (64, 5, 2, 128)
TINY_G_DIMS = (64, 5, 2, 96)  # the SwiGLU trunk: hidden (int(96·2/3) + 7) // 8 · 8 = 64
HW = (42, 56)  # a 3x4 patch grid: the position table interpolated from 37x37


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.fixture(scope="module", autouse=True)
def tiny_presets():
    """The tiny, ViT-L and ViT-G DA3 presets at the tiny widths, in both
    packages."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (J_da3, T_da3):
            for v in ("tiny", "vitl", "vitg"):
                mp.setitem(mod.DA3_PRESETS, v, TINY_PRESET)
            mp.setattr(mod, "DA3_MONO_OUT_LAYERS", TINY_PRESET[0])
        for reg in (J_reg, T_reg):  # the NESTED metric branch reads "vitl"
            mp.setitem(reg.VIT_VARIANTS, "vitl", TINY_DIMS)
            mp.setitem(reg.VIT_VARIANTS, "vitg", TINY_G_DIMS)
        yield


def _noisy(params, seed):
    """Each leaf plus 0.05·N(0, 1), drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(p.shape)).astype(np.float32),
        params)


def _jax_model(mode, variant="tiny", dims=TINY_DIMS):
    h, n, heads, mlp = dims
    return J_da3.DepthAnything3(variant=variant, mode=mode, hidden_size=h, num_layers=n,
                                num_heads=heads, mlp_dim=mlp)


def _port_model(mode, params, variant="tiny", dims=TINY_DIMS, quant=False):
    h, n, heads, mlp = dims
    model = T_da3.DepthAnything3(variant, mode, h, n, heads, mlp, quant=quant).eval()
    model.load_state_dict(from_flax(params), strict=True)
    return model


def _init(mode, variant="tiny", dims=TINY_DIMS, seed=0):
    params = jit_init(_jax_model(mode, variant, dims), jnp.zeros((1, 28, 28, 3), jnp.float32),
                      rng_seed=seed)
    return _noisy(params, seed)


@pytest.fixture(scope="module")
def anyview():
    params = _init("anyview")
    return params, _port_model("anyview", params)


def _pixels(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _predict_both(mode, params, model, x, outputs=None):
    want = jax.jit(_jax_model(mode).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = model.predict(torch.from_numpy(x), outputs)
    return got, want


# ---- positional helpers -----------------------------------------------------------------

@pytest.mark.parametrize("grid", [(3, 4), (20, 36), (1, 1)])
def test_rope_tables_and_positions_equal_jax(grid):
    gh, gw = grid
    pos = T_da3._grid_positions(gh, gw)
    np.testing.assert_array_equal(pos, J_da3._grid_positions(gh, gw))
    for hd in (32, 64):
        for got, want in zip(T_da3._rope_tables(hd, pos), J_da3._rope_tables(hd, pos)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    # the device tables: local = the grid's coordinates; global = every
    # patch at (1, 1), tiled over the views
    # (sin carries rot's sign: minus on the first quarter of each half)
    sign = np.array([-1.0] * 16 + [1.0] * 16 + [-1.0] * 16 + [1.0] * 16, np.float32)
    cos_l, sin_l = T_da3._rope(64, gh, gw, 1, True, torch.device("cpu"), torch.float32)
    want = J_da3._rope_tables(64, pos)
    np.testing.assert_array_equal(cos_l.numpy(), want[0])
    np.testing.assert_array_equal(sin_l.numpy(), want[1] * sign)
    cos_g, sin_g = T_da3._rope(64, gh, gw, 2, False, torch.device("cpu"), torch.float32)
    assert cos_g.shape == (2 * (gh * gw + 1), 64)
    want = J_da3._rope_tables(64, np.concatenate([np.zeros((1, 2)), np.ones((gh * gw, 2))]))
    np.testing.assert_array_equal(cos_g.numpy(), np.tile(want[0], (2, 1)))
    np.testing.assert_array_equal(sin_g.numpy(), np.tile(want[1] * sign, (2, 1)))


@pytest.mark.parametrize("h,w,channels", [(3, 4, 16), (280, 504, 128), (40, 72, 16), (5, 5, 8)])
def test_uv_pos_embed_equals_jax(h, w, channels):
    for aspect in (w / h, 16 / 9):
        got = T_da3._uv_pos_embed(h, w, channels, aspect)
        assert got.dtype == np.float32 and got.shape == (h, w, channels)
        np.testing.assert_array_equal(got, J_da3._uv_pos_embed(h, w, channels, aspect))
    table = T_da3._uv_table(h, w, channels, w / h, torch.device("cpu"), torch.bfloat16)
    assert table.dtype == torch.bfloat16
    assert table is T_da3._uv_table(h, w, channels, w / h, torch.device("cpu"), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64])
def test_apply_rope_matches_jax(hd, dtype):
    """The rotation rounds where JAX's does: equal in f32, and in bf16 (the
    tables cast to the tensor's dtype first, each product rounded)."""
    t = torch.from_numpy(_pixels((2, 13, 3, hd), hd)).to(dtype)
    cos, sin = T_da3._rope(hd, 3, 4, 1, True, torch.device("cpu"), dtype)
    jt = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    jcos, jsin = J_da3._rope_tables(hd, J_da3._grid_positions(3, 4))
    want = np.asarray(J_da3._apply_rope(jt, jnp.asarray(jcos), jnp.asarray(jsin))
                      .astype(jnp.float32))
    got = T_da3._apply_rope(t, cos, sin)
    assert got.dtype == dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---- whole models -----------------------------------------------------------------------

def test_tiny_anyview_returns_every_output_like_jax(anyview):
    params, model = anyview
    x = _pixels((1, *HW, 3), 1)
    got, want = _predict_both("anyview", params, model, x)
    assert set(got) == set(want) == set(T_da3.ANYVIEW_OUTPUTS)
    for key in T_da3.ANYVIEW_OUTPUTS:
        assert got[key].shape == want[key].shape, key
        assert _rel(got[key].numpy(), want[key]) < REL_TOL, key
    # rays at the aux chain's own scale: twice the ×4 stage, 8x the patch grid
    assert got["depth"].shape == (1, 1, *HW) and got["ray"].shape == (1, 1, 24, 32, 6)
    assert got["pose_enc"].shape == (1, 1, 9)


def test_frame_depth_is_the_full_dicts_depth_and_skips_the_rest(anyview, monkeypatch):
    """forward (the frame program's call) gives the dict's depth, and runs
    neither the ray branch nor the camera decoder."""
    _, model = anyview
    x = torch.from_numpy(_pixels((2, *HW, 3), 2))
    with torch.no_grad():
        full = model.predict(x)
        for name in ("_aux",):
            monkeypatch.setattr(model.head, name, lambda *a: pytest.fail("ray branch ran"))
        monkeypatch.setattr(model.cam_dec, "forward", lambda *a: pytest.fail("camera ran"))
        depth = model(x)
        only = model.predict(x, ("depth",))
    assert depth.shape == (2, *HW)
    assert torch.equal(depth, full["depth"][:, 0])
    assert set(only) == {"depth"} and torch.equal(only["depth"], full["depth"])
    with pytest.raises(ValueError, match="sky"):
        model.predict(x, ("depth", "sky"))


@pytest.mark.parametrize("mode", ["mono", "metric"])
def test_single_branch_presets_with_sky_match_jax(mode):
    params = _init(mode, seed=3)
    model = _port_model(mode, params)
    x = _pixels((2, 28, 70, 3), 4)
    got, want = _predict_both(mode, params, model, x)
    assert set(got) == set(want) == {"depth", "sky"}
    for key in ("depth", "sky"):
        assert got[key].shape == want[key].shape == (2, 1, 28, 70)
        assert _rel(got[key].numpy(), want[key]) < REL_TOL, key
    # the frame's depth: the sky post on each batch element
    want_frame = jax.jit(J_da3.da3_depth_apply(_jax_model(mode)))(params, jnp.asarray(x))
    with torch.no_grad():
        got_frame = model(torch.from_numpy(x))
    assert _rel(got_frame.numpy(), want_frame) < REL_TOL


def test_two_views_match_jax(anyview):
    """S=2: the camera token is the mean of the two, global layers attend
    across both views under the tiled RoPE table."""
    params, model = anyview
    x = _pixels((1, 2, 28, 42, 3), 5)
    got, want = _predict_both("anyview", params, model, x)
    for key in T_da3.ANYVIEW_OUTPUTS:
        assert got[key].shape == want[key].shape and got[key].shape[:2] == (1, 2), key
        assert _rel(got[key].numpy(), want[key]) < REL_TOL, key
    # the views see each other: changing view 1 moves view 0's depth
    x2 = x.copy()
    x2[:, 1] = _pixels(x2[:, 1].shape, 6)
    with torch.no_grad():
        moved = model.predict(torch.from_numpy(x2), ("depth",))["depth"]
    assert not torch.allclose(moved[:, 0], got["depth"][:, 0])


def test_swiglu_vitg_trunk_matches_jax():
    params = _init("anyview", "vitg", TINY_G_DIMS, seed=7)
    model = _port_model("anyview", params, "vitg", TINY_G_DIMS)
    mlp = model.backbone.layer[0].mlp
    assert mlp.use_swiglu and mlp.w12.out_features == 2 * 64 and mlp.w3.in_features == 64
    x = _pixels((1, *HW, 3), 8)
    want = jax.jit(_jax_model("anyview", "vitg", TINY_G_DIMS).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = model.predict(torch.from_numpy(x))
    for key in T_da3.ANYVIEW_OUTPUTS:
        assert _rel(got[key].numpy(), want[key]) < REL_TOL, key
    # the MLP alone at ViT-G's real widths: hidden 4096 from mlp_dim 6144
    jm = J_da3.DA3Mlp(1536, 6144, use_swiglu=True)
    h = _pixels((1, 5, 1536), 9)
    p = _noisy(jit_init(jm, jnp.zeros((1, 1, 1536), jnp.float32), rng_seed=1), 1)
    tm = T_da3.DA3Mlp(1536, 6144, use_swiglu=True)
    tm.load_state_dict(from_flax(p), strict=True)
    assert tm.w12.out_features == 2 * 4096
    with torch.no_grad():
        assert _rel(tm(torch.from_numpy(h)).numpy(), jm.apply(p, jnp.asarray(h))) < REL_TOL


# ---- post-processing --------------------------------------------------------------------

def _sky_cases():
    rng = np.random.default_rng(10)
    depth = rng.uniform(0.5, 100.0, (3, 12, 12)).astype(np.float32)
    depth[1, :6] = 7.0  # ties
    sky = np.zeros((3, 12, 12), np.float32)
    sky[0, :3] = 1.0    # 36 sky pixels: filled from this element's own q99
    sky[1, :2] = 0.9    # ties in the non-sky depth
    sky[2, 0, :10] = 1  # 10 sky pixels: not enough, untouched
    return {"per-element": (depth, sky),
            "empty-mask": (depth[:1], np.ones((1, 12, 12), np.float32)),
            "few-non-sky": (depth[:1], np.pad(np.ones((12, 11), np.float32), ((0, 0), (0, 1)))),
            "all-sky-but-ties": (np.full((2, 12, 12), 3.0, np.float32), sky[:2])}


@pytest.mark.parametrize("case", list(_sky_cases()))
def test_sky_to_max_depth_matches_jax(case):
    depth, sky = _sky_cases()[case]
    want = np.asarray(J_da3.sky_to_max_depth(jnp.asarray(depth), jnp.asarray(sky)))
    got = T_da3.sky_to_max_depth(torch.from_numpy(depth), torch.from_numpy(sky)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "per-element":
        assert got[0, :3].max() < 101.0 and np.array_equal(got[2], depth[2])


@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("case", ["mixed", "empty", "one", "ties"])
def test_masked_quantile_matches_jax(q, case):
    rng = np.random.default_rng(11)
    values = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    mask = {"mixed": rng.random((2, 3, 5, 7)) < 0.4, "empty": np.zeros((2, 3, 5, 7), bool),
            "one": np.eye(35, dtype=bool)[[3, 30]].reshape(2, 1, 5, 7).repeat(3, 1)}.get(case)
    if case == "ties":
        values = np.round(values).astype(np.float32)
        mask = rng.random((2, 3, 5, 7)) < 0.7
    want = np.asarray(J_da3._masked_quantile(jnp.asarray(values), jnp.asarray(mask), q))
    got = T_da3._masked_quantile(torch.from_numpy(values), torch.from_numpy(mask), q).numpy()
    assert got.shape == (2,)
    np.testing.assert_array_equal(got, want)


def _nested_inputs(seed, sky_case):
    rng = np.random.default_rng(seed)
    B, S, H, W = 2, 1, 12, 16
    base = rng.uniform(1.0, 2.0, (H, W)).astype(np.float32)
    out = {"depth": np.stack([base, base * 1.5])[:, None],
           "depth_conf": rng.uniform(1.0, 3.0, (B, S, H, W)).astype(np.float32),
           "pose_enc": np.concatenate([rng.standard_normal((B, S, 7)),
                                       rng.uniform(0.5, 1.5, (B, S, 2))], -1).astype(np.float32)}
    sky = np.zeros((B, S, H, W), np.float32)
    if sky_case == "sky":
        sky[:, :, :3] = 1.0
    elif sky_case == "all-sky":
        sky[1] = 1.0  # element 1: an empty non-sky mask
    metric = {"depth": np.stack([base * 3.0, base * 30.0])[:, None] + 0.01, "sky": sky}
    return out, metric, (H, W)


@pytest.mark.parametrize("sky_case", ["none", "sky", "all-sky"])
def test_nested_align_matches_jax(sky_case):
    out, metric, hw = _nested_inputs(12, sky_case)
    want = np.asarray(J_da3.nested_align(jax.tree.map(jnp.asarray, out),
                                         jax.tree.map(jnp.asarray, metric), hw))
    got = T_da3.nested_align({k: torch.from_numpy(v) for k, v in out.items()},
                             {k: torch.from_numpy(v) for k, v in metric.items()}, hw).numpy()
    assert got.shape == want.shape == (2, 1, 12, 16)
    assert _rel(got, want) < 1e-6
    if sky_case == "all-sky":
        np.testing.assert_array_equal(got[1], 200.0)  # no alignment: the sky cap


def test_pose_encoding_matches_jax():
    pose = _pixels((2, 3, 9), 13)
    want = J_da3.pose_encoding_to_extri_intri(jnp.asarray(pose), (28, 70))
    got = T_da3.pose_encoding_to_extri_intri(torch.from_numpy(pose), (28, 70))
    for g, w, shape in zip(got, want, ((2, 3, 3, 4), (2, 3, 3, 3))):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# ---- NESTED ----------------------------------------------------------------------------

NESTED_SPEC = dict(name="DA3NESTED-GIANT-LARGE", family="da3", variant="vitg", hf_repo="none",
                   metric=True)


@pytest.fixture(scope="module")
def nested():
    """JAX's build_da3_nested on the tiny widths (branches seeded 0 and 1),
    and the port's DA3Nested with its weights."""
    apply, params, _ = J_da3.build_da3_nested(JSpec(**NESTED_SPEC), init_size=28, rng_seed=0)
    params = _noisy(params, 14)
    model = T_da3.DA3Nested.from_spec(TSpec(**NESTED_SPEC)).eval()
    model.load_state_dict(from_flax(params), strict=True)
    return jax.jit(apply), params, model


def test_tiny_nested_pair_matches_jax(nested):
    apply, params, model = nested
    x = _pixels((2, *HW, 3), 15)
    want = apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape == (2, *HW)
    assert _rel(got.numpy(), want) < REL_TOL
    assert model.da3.backbone.layer[0].mlp.use_swiglu
    assert not model.da3_metric.backbone.layer[0].mlp.use_swiglu


def test_nested_draws_its_branches_from_seed_and_seed_plus_one():
    a, spec = T_factory.build_bound("DA3NESTED-GIANT-LARGE", device="cpu", seed=4)
    b, _ = T_factory.build_bound("DA3-GIANT", device="cpu", seed=4)
    c, _ = T_factory.build_bound("DA3METRIC-LARGE", device="cpu", seed=5)
    assert isinstance(a, T_da3.DA3Nested) and spec.variant == "vitg"
    for branch, alone in ((a.da3, b), (a.da3_metric, c)):
        want = alone.state_dict()
        got = branch.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    # the camera token is drawn from N(0, 1); the position table stays zero
    assert a.da3.backbone.camera_token.abs().max() > 0.1
    assert not a.da3.backbone.pos_embed.any()


def test_nested_refuses_int8_like_jax():
    with pytest.raises(NotImplementedError, match="NESTED") as e:
        T_factory.build_bound("DA3NESTED-GIANT-LARGE", device="cpu", quant="int8")
    with pytest.raises(NotImplementedError) as j:
        from desktop2stereo_tpu.models.factory import build_model
        build_model("DA3NESTED-GIANT-LARGE", quant="int8")
    assert str(e.value) == str(j.value)


# ---- int8 -----------------------------------------------------------------------------

def test_int8_matches_jax_int8_and_tracks_float(anyview):
    """The trunk's four products a layer on the int8 dense (its plain version
    here), the heads float: against JAX's int8 model on its CPU dispatch,
    and against the float model (JAX's bound for DA3: correlation > 0.99)."""
    params, model = anyview
    qparams = jax.tree.map(np.asarray, J_quant.quantize_tree(params))
    qmodel = _port_model("anyview", qparams, quant=True)
    x = _pixels((1, *HW, 3), 16)
    want = jax.jit(J_da3.da3_depth_apply(
        J_da3.DepthAnything3("tiny", "anyview", *TINY_DIMS, quant=True)))(qparams, jnp.asarray(x))
    with torch.no_grad():
        got = qmodel(torch.from_numpy(x))
        flt = model(torch.from_numpy(x))
    assert _rel(got.numpy(), want) < REL_TOL
    corr = np.corrcoef(got.numpy().ravel(), flt.numpy().ravel())[0, 1]
    assert corr > 0.99, corr
    names = {k.rsplit(".", 2)[-2] for k in qmodel.state_dict() if k.endswith("weight_q")}
    assert names == {"qkv", "proj", "fc1", "fc2"}


def test_build_bound_draws_the_da3_parameters_from_the_seed():
    """Kernels lecun-drawn (the patch kernel among them), the camera token
    from N(0, 1), the QK norms at one and zero, the position table and cls
    token zero; int8 quantizes the trunk's products only."""
    a, spec = T_factory.build_bound("DA3-LARGE", device="cpu", seed=2)
    b, _ = T_factory.build_bound("DA3-LARGE", device="cpu", seed=2)
    assert spec.family == "da3" and isinstance(a, T_da3.DepthAnything3) and a.anyview
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    bb = a.backbone
    assert 0.5 < bb.camera_token.std().item() < 1.5
    fan_in = bb.patch_kernel.shape[0]
    assert 0.5 < bb.patch_kernel.std().item() * fan_in ** 0.5 < 1.5
    assert not bb.pos_embed.any() and not bb.cls_token.any()
    attn = bb.layer[TINY_PRESET[1]].attention
    assert torch.equal(attn.q_norm.weight, torch.ones(32)) and not attn.k_norm.bias.any()
    assert not hasattr(bb.layer[TINY_PRESET[1] - 1].attention, "q_norm")
    x = torch.from_numpy(_pixels((1, *HW, 3), 17))
    with torch.no_grad():
        depth = a(x)
    assert depth.shape == (1, *HW) and torch.isfinite(depth).all()
    q, _ = T_factory.build_bound("DA3-LARGE", device="cpu", seed=2, quant="int8")
    quantized = {k.rsplit(".", 1)[0] for k in q.state_dict() if k.endswith("weight_q")}
    assert quantized and all(k.startswith("backbone.layer.") for k in quantized)
    assert isinstance(q.cam_dec.fc1, torch.nn.Linear)


# ---- checkpoints ------------------------------------------------------------------------

def _reference_arrays(rng, dims, preset, anyview, swiglu=False, prefix=""):
    """A DA3 checkpoint in the reference's naming (model.backbone.pretrained.*,
    model.head.*, model.cam_dec.*) at the given widths, F16 values drawn
    from a seeded normal (×0.02)."""
    D, layers, heads, mlp = dims
    out_layers, alt_start, neck, fc = preset
    dim_in = 2 * D if anyview else D
    sd = {}

    def add(name, *shape):
        sd[prefix + name] = (rng.standard_normal(shape, dtype=np.float32) * 0.02).astype(np.float16)

    bp = "backbone.pretrained."
    add(bp + "cls_token", 1, 1, D)
    add(bp + "pos_embed", 1, 37 * 37 + 1, D)
    add(bp + "patch_embed.proj.weight", D, 3, 14, 14)
    for n in ("patch_embed.proj.bias", "norm.weight", "norm.bias"):
        add(bp + n, D)
    if anyview:
        add(bp + "camera_token", 1, 2, D)
    for i in range(layers):
        p = f"{bp}blocks.{i}."
        for n in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "attn.proj.bias",
                  "ls1.gamma", "ls2.gamma"):
            add(p + n, D)
        add(p + "attn.qkv.weight", 3 * D, D)
        add(p + "attn.qkv.bias", 3 * D)
        add(p + "attn.proj.weight", D, D)
        if anyview and i >= alt_start:
            for n in ("q_norm", "k_norm"):
                add(p + f"attn.{n}.weight", D // heads)
                add(p + f"attn.{n}.bias", D // heads)
        if swiglu:
            hidden = (int(mlp * 2 / 3) + 7) // 8 * 8
            add(p + "mlp.w12.weight", 2 * hidden, D)
            add(p + "mlp.w12.bias", 2 * hidden)
            add(p + "mlp.w3.weight", D, hidden)
            add(p + "mlp.w3.bias", D)
        else:
            add(p + "mlp.fc1.weight", mlp, D)
            add(p + "mlp.fc1.bias", mlp)
            add(p + "mlp.fc2.weight", D, mlp)
            add(p + "mlp.fc2.bias", D)
    if anyview:
        add("head.norm.weight", dim_in)
        add("head.norm.bias", dim_in)
    for i, c in enumerate(neck):
        add(f"head.projects.{i}.weight", c, dim_in, 1, 1)
        add(f"head.projects.{i}.bias", c)
        add(f"head.scratch.layer{i + 1}_rn.weight", fc, c, 3, 3)
    for i, k in ((0, 4), (1, 2), (3, 3)):
        add(f"head.resize_layers.{i}.weight", neck[i], neck[i], k, k)
        add(f"head.resize_layers.{i}.bias", neck[i])
    sp = "head.scratch."
    for tag in ("", "_aux") if anyview else ("",):
        for rn in (1, 2, 3, 4):
            p = f"{sp}refinenet{rn}{tag}."
            add(p + "out_conv.weight", fc, fc, 1, 1)
            add(p + "out_conv.bias", fc)
            for unit in (1, 2):  # refinenet4's unit 1 ships, and is never used
                for conv in (1, 2):
                    add(p + f"resConfUnit{unit}.conv{conv}.weight", fc, fc, 3, 3)
                    add(p + f"resConfUnit{unit}.conv{conv}.bias", fc)
    add(sp + "output_conv1.weight", fc // 2, fc, 3, 3)
    add(sp + "output_conv1.bias", fc // 2)
    add(sp + "output_conv2.0.weight", 32, fc // 2, 3, 3)
    add(sp + "output_conv2.0.bias", 32)
    add(sp + "output_conv2.2.weight", 2 if anyview else 1, 32, 1, 1)
    add(sp + "output_conv2.2.bias", 2 if anyview else 1)
    if anyview:
        widths = (fc // 2, fc, fc // 2, fc, fc // 2)
        for k, (c_in, c_out) in enumerate(zip((fc,) + widths[:-1], widths)):
            add(f"{sp}output_conv1_aux.3.{k}.weight", c_out, c_in, 3, 3)
            add(f"{sp}output_conv1_aux.3.{k}.bias", c_out)
        add(sp + "output_conv1_aux.0.0.weight", fc // 2, fc, 3, 3)  # an unused level
        add(sp + "output_conv2_aux.3.0.weight", 32, fc // 2, 3, 3)
        add(sp + "output_conv2_aux.3.0.bias", 32)
        add(sp + "output_conv2_aux.3.2.weight", 32)
        add(sp + "output_conv2_aux.3.2.bias", 32)
        add(sp + "output_conv2_aux.3.5.weight", 7, 32, 1, 1)
        add(sp + "output_conv2_aux.3.5.bias", 7)
        for n, o in (("backbone.0", dim_in), ("backbone.2", dim_in), ("fc_t", 3),
                     ("fc_qvec", 4), ("fc_fov.0", 2)):
            add(f"cam_dec.{n}.weight", o, dim_in)
            add(f"cam_dec.{n}.bias", o)
    else:
        add(sp + "sky_output_conv2.0.weight", 32, fc // 2, 3, 3)
        add(sp + "sky_output_conv2.0.bias", 32)
        add(sp + "sky_output_conv2.2.weight", 1, 32, 1, 1)
        add(sp + "sky_output_conv2.2.bias", 1)
    return sd


def _assert_same_tree(got, want):
    want = jax.tree_util.tree_leaves_with_path(want)
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_da3_small_checkpoint_loads_as_the_jax_converter_reads_it(tmp_path):
    """A real-shape DA3-SMALL checkpoint (the reference's naming under
    `model.`, F16) written by the port's safetensors writer: the port's
    converter gives the JAX converter's tree, and `build_bound` with it holds
    exactly `from_flax` of that tree."""
    spec = T_reg.get_spec("DA3-SMALL")
    jspec = J_reg.get_spec("DA3-SMALL")
    sd = _reference_arrays(np.random.default_rng(18), spec.dims, T_da3.DA3_PRESETS["vits"],
                           anyview=True, prefix="model.")
    path = tmp_path / "model.safetensors"
    safetensors_io.save_file(sd, path)
    jtree = J_convert.convert_da3(sd, jspec)
    _assert_same_tree(T_convert.convert_da3(str(path), spec), jtree)
    model, _ = T_factory.build_bound("DA3-SMALL", device="cpu", checkpoint=str(path))
    want = from_flax(jtree)
    got = model.state_dict()
    assert set(got) == set(want) and len(got) > 200
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the conv-transposes keep (C, O, f, f); the convs go HWIO → OIHW
    np.testing.assert_array_equal(got["head.reassemble.resize.0.weight"].numpy(),
                                  sd["model.head.resize_layers.0.weight"].astype(np.float32))
    np.testing.assert_array_equal(got["head.reassemble.resize.3.weight"].numpy(),
                                  sd["model.head.resize_layers.3.weight"].astype(np.float32))


@pytest.mark.parametrize("layout", ["model.da3.", "model.da3.model."])
def test_nested_checkpoint_branches_convert_like_jax(layout):
    """DA3NESTED's two branches (model.da3[.model].*, model.da3_metric
    [.model].*; the SwiGLU anyview trunk, the metric DPT with its sky head)
    against JAX build_da3_nested's reading of the same arrays."""
    rng = np.random.default_rng(19)
    metric_prefix = layout.replace("da3.", "da3_metric.")
    sd = {**_reference_arrays(rng, TINY_G_DIMS, TINY_PRESET, True, True, layout),
          **_reference_arrays(rng, TINY_DIMS, TINY_PRESET, False, False, metric_prefix)}
    _, jparams, _ = J_da3.build_da3_nested(JSpec(**NESTED_SPEC), checkpoint=sd)
    tree = T_convert.convert_da3_nested(sd, TSpec(**NESTED_SPEC))
    _assert_same_tree(tree, jparams["params"])
    model = T_da3.DA3Nested.from_spec(TSpec(**NESTED_SPEC))
    model.load_state_dict(from_flax(tree), strict=True)


# ---- the frame program ------------------------------------------------------------------

SPEC = dict(name="da3-test", family="da3", variant="vits", hf_repo="none", metric=True)
CFG = dict(model_name="da3-test", depth_resolution=126, output_height=180, ipd=0.064,
           depth_strength=2.0, convergence=0.01, foreground_scale=0.0, aa_strength=2.0,
           ema_alpha=0.9, temporal_smooth=True, quality="high", emit_depth="model")


@pytest.fixture(scope="module")
def mono():
    params = _init("mono", seed=20)
    return params, _port_model("mono", params)


@pytest.mark.parametrize("mode", ["anyview", "mono"])
def test_program_cache_matches_jax(anyview, mono, jax_kernels, mode):  # noqa: F811
    """Three 180x320 frames at depth resolution 126 (a 70x126 model input)
    through both ProgramCaches (Half-SBS, the fused tail; the JAX side on its
    TPU dispatch with the DIBR kernel in interpret mode): the frames within
    the pipeline test's thresholds, the EMA carried."""
    params, model = anyview if mode == "anyview" else mono
    calls = jax_kernels["dibr_render_pair_planar"].calls
    bound = J_programs.BoundModel.stateless(J_da3.da3_depth_apply(_jax_model(mode)), params)
    jcfg = J_programs.ProgramConfig(**dict(CFG, display_mode="Half-SBS"))
    jprog = J_programs.ProgramCache(jcfg, bound, JSpec(**SPEC), compute_dtype=jnp.float32)
    cfg = T_programs.ProgramConfig(**dict(CFG, display_mode="Half-SBS"))
    tprog = T_programs.ProgramCache(cfg, model, TSpec(**SPEC), compute_dtype=torch.float32)
    for frame in _frames():
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        assert t_sbs.shape == (180, 320, 3) and t_depth.shape == (70, 126)
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
    assert jax_kernels["dibr_render_pair_planar"].calls > calls


def test_engine_delivers_the_program_cache_frames(anyview):
    frames = _frames(4)
    cfg = T_programs.ProgramConfig(**dict(CFG, display_mode="Half-SBS"))
    prog = T_programs.ProgramCache(cfg, anyview[1], TSpec(**SPEC), compute_dtype=torch.float32)
    prog.warmup((180, 320, 4))
    source = _LockstepSource(frames)
    sink = _RecordingSink(source)
    stats = FrameEngine(source, prog, sink, target_fps=0.0).run(duration=120.0)
    assert stats.frames == 4 and len(sink.pushed) == 4
    direct = T_programs.ProgramCache(cfg, anyview[1], TSpec(**SPEC), compute_dtype=torch.float32)
    for (sbs, depth), frame in zip(sink.pushed, frames):
        want_sbs, want_depth = direct(frame)
        np.testing.assert_array_equal(sbs, want_sbs.numpy())
        np.testing.assert_array_equal(depth, want_depth.numpy())


# ---- the CLI ----------------------------------------------------------------------------

def test_cli_runs_da3_small_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "desktop2stereo_tpu_torch.cli", "--device", "cpu", "--source",
         "synthetic", "--size", "64x112", "--frames", "2", "--sink", "null", "--model",
         "DA3-SMALL", "--depth-res", "56", "--stop-file", str(tmp_path / "stop.request")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "device: cpu" in proc.stdout and "[d2s] done:" in proc.stdout


def test_cli_refuses_int8_nested_before_building(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    drawn = []
    monkeypatch.setattr(T_factory, "init_random", lambda *a: drawn.append(a))
    with pytest.raises(SystemExit) as e:
        T_cli.run(["--device", "cpu", "--model", "DA3NESTED-GIANT-LARGE", "--quant", "int8",
                   "--source", "synthetic", "--size", "64x112", "--frames", "1",
                   "--sink", "null"])
    assert e.value.code == f"[d2s] {T_factory.NESTED_QUANT_MESSAGE}"
    assert drawn == []


def test_batch_of_two_equals_each_image_alone(anyview):
    """The batched multi-stream program runs the model at batch S
    (`BatchedProgramCache`): each row of a batch of two equals that image
    alone, within REL_TOL (each batch row one view)."""
    _, model = anyview
    x = _pixels((2, *HW, 3), 61)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        for s in range(2):
            one = model(torch.from_numpy(x[s:s + 1])).numpy()
            assert _rel(got[s:s + 1], one) < REL_TOL
