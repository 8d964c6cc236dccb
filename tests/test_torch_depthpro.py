"""The port's DepthPro (`models/depthpro.py`) against the JAX package's, on
the CPU in f32: the tile split and merge, the folded upsample expansions,
the DINOv2 towers' raw hooks, the whole model at the JAX parity test's
small configuration and at its non-divisible-tile one
(`tests/test_models_depthpro.py`), the converter, the int8 form, the
square-only preprocess and EMA carry of the frame program, and one frame
program.

Weights come from the JAX module's init, every leaf moved by seeded noise,
and reach the port through `from_flax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.models.depthpro as J_dp
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import get_spec as j_get_spec
from desktop2stereo_tpu.models import convert_hf as J_convert
from desktop2stereo_tpu.models.dinov2 import Dinov2Encoder as JEncoder
from desktop2stereo_tpu.models.dpt import compose_expand as j_compose_expand
from desktop2stereo_tpu.models.init_util import jit_init
import desktop2stereo_tpu_torch.models.depthpro as T_dp
import desktop2stereo_tpu_torch.models.factory as factory
from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder
from desktop2stereo_tpu_torch.models.dpt import compose_expand
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.models.safetensors_io import save_file
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, quantize_state_dict
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from torch_classic_dpt import (  # noqa: F401
    CFG, INT8_TOL, Synth, _assert_frames_match, _frames, assert_trees_equal, jax_kernels,
    perturb, port_depth, rel)
from torch_threads import one_torch_thread  # noqa: F401

# the JAX parity test's small configurations (tests/test_models_depthpro.py)
SMALL = dict(patch_px=32, vit_hidden=32, vit_layers=4, vit_heads=4, vit_mlp=128, vit_patch=8,
             fusion=16, scaled_dims=(32, 32, 16), hook_ids=(2, 1), hook_dims=(16, 16))
NONDIV = dict(SMALL, patch_px=24, vit_patch=7)  # 24-px tiles, patch 7: 3 px dropped
CONFIGS = {"small": (SMALL, 128), "nondivisible": (NONDIV, 96)}
DP_TOL = 1e-4  # f32 depth, port against JAX: max |port - JAX| / max |JAX|
MAP_TOL = 1e-5  # f32 intermediate maps and hidden states


def _x(seed, size):
    return np.random.default_rng(seed).standard_normal((1, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def dp():
    """config → (JAX module, JAX params, port DepthPro) from one JAX init."""
    out = {}
    for i, (key, (cfg, size)) in enumerate(CONFIGS.items()):
        jm = J_dp.DepthPro(**cfg)
        params = perturb(jit_init(jm, jnp.zeros((1, size, size, 3), jnp.float32),
                                  rng_seed=i), seed=80 + i)
        model = T_dp.DepthPro(**cfg).eval()
        model.load_state_dict(from_flax(params), strict=True)
        out[key] = (jm, params, model)
    return out


@pytest.mark.parametrize("size,patch,overlap", [(128, 32, 0.25), (64, 32, 0.5), (32, 32, 0.0),
                                                (96, 24, 0.25), (1536, 384, 0.25)])
def test_split_to_patches_matches_jax(size, patch, overlap):
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(J_dp.split_to_patches(jnp.asarray(x), patch, overlap))
    got = T_dp.split_to_patches(torch.from_numpy(x), patch, overlap).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,h,padding", [(25, 4, 3), (9, 27, 6), (25, 27, 3), (1, 27, 12),
                                         (4, 8, 5)])
def test_merge_patches_matches_jax(n, h, padding):
    x = np.random.default_rng(n * h).standard_normal((2 * n, h, h, 5)).astype(np.float32)
    want = np.asarray(J_dp.merge_patches(jnp.asarray(x), 2, padding))
    got = T_dp.merge_patches(torch.from_numpy(x), 2, padding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias,deconv_bias", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_compose_expand_matches_jax(bias, deconv_bias):
    rng = np.random.default_rng(5)
    k = rng.standard_normal((6, 2, 2, 5)).astype(np.float32)
    b = rng.standard_normal((2, 2, 5)).astype(np.float32) if bias else None
    dk = rng.standard_normal((5, 7, 2, 2)).astype(np.float32)
    db = rng.standard_normal((7,)).astype(np.float32) if deconv_bias else None
    jk, jb = j_compose_expand(jnp.asarray(k), None if b is None else jnp.asarray(b),
                              jnp.asarray(dk), None if db is None else jnp.asarray(db))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    tk, tb = compose_expand(t(k), t(b), t(dk), t(db))
    assert tk.shape == (6, 4, 4, 7) and rel(tk.numpy(), jk) < 1e-6
    assert (tb is None) == (jb is None)
    if tb is not None:
        assert tb.shape == (4, 4, 7) and rel(tb.numpy(), jb) < 1e-6


def test_dinov2_hooks_are_raw_and_the_last_state_normed(dp):
    """The patch encoder: the 27²-style table of its own grid, the hooks'
    raw hidden states and the final LayerNorm on the last one only."""
    jm, params, model = dp["small"]
    kw = dict(hidden_size=32, num_layers=4, num_heads=4, mlp_dim=128, out_layers=(1, 2, 3),
              patch_size=8, pretrain_grid=4, final_norm_indices=(3,))
    tm = Dinov2Encoder(**{k: v for k, v in kw.items() if k != "out_layers"},
                       out_layers=kw["out_layers"]).eval()
    tree = {"params": params["params"]["patch_encoder"]}
    tm.load_state_dict(from_flax(tree), strict=True)
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = JEncoder(**kw).apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) < MAP_TOL
    assert not torch.allclose(got[0], tm.layernorm(got[0]))  # the hooks are not


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_depthpro_matches_jax(dp, key):
    jm, params, model = dp[key]
    size = CONFIGS[key][1]
    x = _x(90 + size, size)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = port_depth(model, x)
    assert got.shape == want.shape == (1, 2 * size, 2 * size) and np.isfinite(got).all()
    assert rel(got, want) < DP_TOL


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_encoder_maps_match_jax(dp, key):
    """The image encoder's map and the five merged encoder maps, the JAX
    module's `debug_features` output."""
    jm, params, model = dp[key]
    size = CONFIGS[key][1]
    x = _x(91, size)
    j_feats, j_ups = J_dp.DepthPro(**CONFIGS[key][0], debug_features=True).apply(
        params, jnp.asarray(x))
    with torch.no_grad():
        image, feats = model.encode(torch.from_numpy(x))
    for g, w in zip([image, *feats], j_feats):
        assert g.shape == w.shape and rel(g.numpy(), w) < MAP_TOL


# ---- the converter and build_bound --------------------------------------------------------------

def hf_depthpro(seed, cfg=SMALL):
    """A synthetic HF DepthProForDepthEstimation state dict (no FOV branch)."""
    s = Synth(seed)
    D, L, mlp, p = cfg["vit_hidden"], cfg["vit_layers"], cfg["vit_mlp"], cfg["vit_patch"]
    grid = cfg["patch_px"] // p
    for tower in ("patch_encoder", "image_encoder"):
        bp = f"depth_pro.encoder.{tower}.model."
        s.arr(bp + "embeddings.cls_token", (1, 1, D))
        s.arr(bp + "embeddings.position_embeddings", (1, grid * grid + 1, D), std=0.5)
        s.conv(bp + "embeddings.patch_embeddings.projection", 3, D, p)
        for i in range(L):
            lp = f"{bp}encoder.layer.{i}."
            s.norm(lp + "norm1", D)
            s.norm(lp + "norm2", D)
            for n in ("query", "key", "value"):
                s.linear(lp + "attention.attention." + n, D, D)
            s.linear(lp + "attention.output.dense", D, D)
            s.arr(lp + "layer_scale1.lambda1", (D,), std=0.1, mean=1.0)
            s.arr(lp + "layer_scale2.lambda1", (D,), std=0.1, mean=1.0)
            s.linear(lp + "mlp.fc1", D, mlp)
            s.linear(lp + "mlp.fc2", mlp, D)
        s.norm(bp + "layernorm", D)
    up = "depth_pro.neck.feature_upsample."
    dims, hooks, fusion = cfg["scaled_dims"], cfg["hook_dims"], cfg["fusion"]

    def deconv(name, cin, cout, bias):
        s.arr(name + ".weight", (cin, cout, 2, 2), std=cin ** -0.5)
        if bias:
            s.arr(name + ".bias", (cout,), std=0.05)

    deconv(up + "image_block.layers.0", D, dims[0], True)
    for i, d in enumerate(dims):
        s.conv(f"{up}scaled_images.{i}.layers.0", D, d, 1, bias=False)
        deconv(f"{up}scaled_images.{i}.layers.1", d, d, False)
    for i, d in enumerate(hooks):
        inter = fusion if i == 0 else d
        s.conv(f"{up}intermediate.{i}.layers.0", D, inter, 1, bias=False)
        for li in range(2 + i):
            deconv(f"{up}intermediate.{i}.layers.{li + 1}", inter if li == 0 else d, d, False)
    s.conv("depth_pro.neck.fuse_image_with_low_res", 2 * dims[0], dims[0], 1)
    for i, c in enumerate((*dims, *hooks)[:4]):
        s.conv(f"depth_pro.neck.feature_projection.projections.{i}", c, fusion, 3, bias=False)
    for j in range(len(dims) + len(hooks) - 1):
        fp = f"fusion_stage.intermediate.{j}."
        for r in ((1, 2) if j else (2,)):
            for c in (1, 2):
                s.conv(f"{fp}residual_layer{r}.convolution{c}", fusion, fusion, 3)
        deconv(fp + "deconv", fusion, fusion, False)
        s.conv(fp + "projection", fusion, fusion, 1)
    for r in (1, 2):
        for c in (1, 2):
            s.conv(f"fusion_stage.final.residual_layer{r}.convolution{c}", fusion, fusion, 3)
    s.conv("fusion_stage.final.projection", fusion, fusion, 1)
    s.conv("head.layers.0", fusion, fusion // 2, 3)
    deconv("head.layers.1", fusion // 2, fusion // 2, True)
    s.conv("head.layers.2", fusion // 2, 32, 3)
    s.conv("head.layers.4", 32, 1, 1)
    s.sd["head.layers.4.bias"] += 0.5  # most of the depth above the final ReLU
    return s.sd


def test_converter_gives_the_jax_tree(tmp_path, monkeypatch):
    """The same numpy tree as the JAX converter, the ConvTranspose layouts
    of the upsample blocks, the fusion layers and the head included; then
    `build_bound(..., checkpoint=)` loads it strict through the port's
    safetensors writer and reader, and runs the JAX model's depth."""
    sd = hf_depthpro(100)
    spec = get_spec("DepthPro-Large")
    tree = T_convert.convert_depthpro(sd, spec, num_layers=4)
    want = J_convert.convert_depthpro(sd, j_get_spec("DepthPro-Large"), num_layers=4)
    assert_trees_equal(tree, want)
    assert tree["intermediate_1"]["layers_3"]["kernel"].shape == (16, 16, 2, 2)
    assert tree["scaled_0"]["layers_0"]["kernel"].shape == (1, 1, 32, 32)
    state = from_flax(want)
    np.testing.assert_array_equal(state["fusion.1.deconv.weight"].numpy(),
                                  sd["fusion_stage.intermediate.1.deconv.weight"])
    np.testing.assert_array_equal(state["scaled.2.layers.0.weight"].numpy(),
                                  sd["depth_pro.neck.feature_upsample.scaled_images.2.layers.0."
                                     "weight"])
    path = tmp_path / "model.safetensors"
    save_file(sd, path)
    monkeypatch.setitem(factory.FAMILIES, "depthpro", (
        lambda s, quant=False: T_dp.DepthPro(**SMALL, quant=quant),
        lambda ckpt, s: T_convert.convert_depthpro(ckpt, s, num_layers=4)))
    model, spec = factory.build_bound("DepthPro-Large", device="cpu", checkpoint=str(path))
    x = _x(101, 128)
    jd = np.asarray(J_dp.DepthPro(**SMALL).apply({"params": want}, jnp.asarray(x)))
    assert rel(port_depth(model, x), jd) < DP_TOL


def test_int8_matches_jax(dp):
    """Both ViT towers' four products a layer int8, the decoder float: the
    port's quantisation equals the JAX tree's, and the int8 models agree."""
    jm, params, model = dp["small"]
    scope = factory.QUANT_SCOPES["depthpro"]
    qtree = jax.tree.map(np.asarray, J_quant.quantize_tree(params, scope=scope))
    state = quantize_state_dict(model.state_dict(), scope)
    want = from_flax(qtree)
    assert set(state) == set(want)
    quantized = [k[: -len(".weight_q")] for k in want if k.endswith(".weight_q")]
    assert len(quantized) == 2 * 4 * 4
    assert {k.split(".")[0] for k in quantized} == {"patch_encoder", "image_encoder"}
    for k in quantized:
        assert torch.equal(state[k + ".weight_q"], want[k + ".weight_q"]), k
        assert torch.equal(state[k + ".scale"], want[k + ".scale"]), k
    qmodel = T_dp.DepthPro(**SMALL, quant=True).eval()
    qmodel.load_state_dict(state, strict=True)
    assert sum(isinstance(m, QuantLinear) for m in qmodel.modules()) == 32
    assert qmodel.fusion[0].projection.weight.dtype == torch.float32
    x = _x(102, 128)
    jq = J_dp.DepthPro(**SMALL, quant=True)
    want_d = np.asarray(jax.jit(jq.apply)(qtree, jnp.asarray(x)))
    assert rel(port_depth(qmodel, x), want_d) < INT8_TOL


# ---- the frame program -------------------------------------------------------------------------

DP_CFG = dict(CFG, model_name="DepthPro-Large", depth_resolution=128)


@pytest.mark.parametrize("mode", ["Half-SBS", "Full-SBS"], ids=["fused", "generic"])
def test_square_only_preprocess_and_carry_match_jax(jax_kernels, mode):  # noqa: F811
    """A square-only model's input: the frame resized bilinearly without
    antialias to depth_resolution², normalised half; the EMA carry named
    depth_resolution², as JAX's `ema_shape` names it.  Through the fused
    preprocess (Half-SBS) and the shared one (Full-SBS)."""
    cfg = dict(DP_CFG, display_mode=mode)
    jspec, tspec = j_get_spec("DepthPro-Large"), get_spec("DepthPro-Large")
    step = J_programs.build_frame_step(
        J_programs.ProgramConfig(**cfg),
        J_programs.BoundModel.stateless(lambda p, x: x[..., 0], {}), jspec,
        compute_dtype=jnp.float32)
    tprog = T_programs.FrameProgram(T_programs.ProgramConfig(**cfg), torch.nn.Identity(),
                                    tspec, compute_dtype=torch.float32)
    for frame in _frames(2):
        j_rgb, j_in = (np.asarray(a) for a in step.stages[0](jnp.asarray(frame)))
        t_rgb, t_in = (a.numpy() for a in tprog.preprocess(torch.from_numpy(frame)))
        assert t_in.shape == j_in.shape == (1, 128, 128, 3)
        assert t_rgb.shape == j_rgb.shape
        assert rel(t_in, j_in) < MAP_TOL and rel(t_rgb, j_rgb) < MAP_TOL
    assert (T_programs.ema_shape(tprog.cfg, tspec, 180, 320)
            == J_programs.ema_shape(J_programs.ProgramConfig(**cfg), jspec, 180, 320)
            == (128, 128))


def test_program_cache_matches_jax(dp, jax_kernels):  # noqa: F811
    """Three 180x320 frames through both ProgramCaches at the small config
    on the square 128 input (depth 256², twice the input's side): frames and
    depth at the pipeline thresholds.  The first frame passes through the
    EMA (its carry was named 128²) and seeds a 256² carry, which the next
    frames smooth against, in JAX as in the port."""
    jm, params, model = dp["small"]
    cfg = dict(DP_CFG, display_mode="Half-SBS")
    jprog = J_programs.ProgramCache(J_programs.ProgramConfig(**cfg),
                                    J_programs.BoundModel.stateless(jm.apply, params),
                                    j_get_spec("DepthPro-Large"), compute_dtype=jnp.float32)
    tprog = T_programs.ProgramCache(T_programs.ProgramConfig(**cfg), model,
                                    get_spec("DepthPro-Large"), compute_dtype=torch.float32)
    for frame in _frames(3):
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
        key = (0, 180, 320)
        assert (tuple(tprog._states[key].ema_depth.shape)
                == tuple(jprog._states[key].ema_depth.shape) == (256, 256))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_build_bound_builds_depthpro(quant, monkeypatch):
    """`build_bound("DepthPro-Large", quant=...)` on the CPU, seeded, with
    the small configuration's module: int8 on both towers' products
    (QUANT_SCOPES), the decoder float; depth twice the input's side."""
    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", ())
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    monkeypatch.setitem(factory.FAMILIES, "depthpro", (
        lambda s, quant=False: T_dp.DepthPro(**SMALL, quant=quant),
        factory.FAMILIES["depthpro"][1]))
    model, spec = factory.build_bound("DepthPro-Large", device="cpu", quant=quant)
    assert spec.square_only and spec.resolutions == (1536,)
    quantized = [n for n, m in model.named_modules() if isinstance(m, QuantLinear)]
    assert len(quantized) == (32 if quant == "int8" else 0)
    assert {n.split(".")[0] for n in quantized} <= {"patch_encoder", "image_encoder"}
    with torch.no_grad():
        d = model(torch.from_numpy(_x(103, 128)))
    assert d.shape == (1, 256, 256) and bool(torch.isfinite(d).all())


@pytest.mark.parametrize("hw", [(96, 96), (128, 160)], ids=["too-small", "not-square"])
def test_depthpro_refuses_an_input_it_cannot_tile(dp, hw):
    with pytest.raises(ValueError, match="square input of at least 128 px"):
        dp["small"][2](torch.zeros(1, *hw, 3))


def test_batch_of_two_equals_each_image_alone(dp):
    """The batched multi-stream program runs the model at batch S
    (`BatchedProgramCache`): each row of a batch of two equals that image
    alone, within DP_TOL (35·S tiles through one trunk)."""
    _, _, model = dp["small"]
    size = CONFIGS["small"][1]
    x = np.concatenate([_x(91, size), _x(92, size)])
    got = port_depth(model, x)
    assert got.shape == (2, 2 * size, 2 * size)
    for s in range(2):
        assert rel(got[s:s + 1], port_depth(model, x[s:s + 1])) < DP_TOL
