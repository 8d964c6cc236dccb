"""The port's InfiniDepth (`models/infinidepth.py`) against the JAX
package's, on the CPU in f32: the RoPE tables (exactly) and their
application, the four DINOv3 encoders at their real widths and a reduced
depth (SmallPlus with its SwiGLU), the f32 conv stem and the implicit head
alone, the layout q/k/v reach the attention in, the converter with the
masked k-bias fold, the int8 form and one frame program.

The depth of every encoder is cut to two blocks in both packages'
`DINOV3_CONFIGS`; the widths stay.  Weights come from the JAX module's
init, every leaf moved by seeded noise, and reach the port through
`from_flax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.models.infinidepth as J_inf
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import get_spec as j_get_spec
from desktop2stereo_tpu.models import convert_hf as J_convert
from desktop2stereo_tpu.models.init_util import jit_init
import desktop2stereo_tpu_torch.models.factory as factory
import desktop2stereo_tpu_torch.models.infinidepth as T_inf
from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.core.runtime import F32Module
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.models.safetensors_io import save_file
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, quantize_state_dict
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from torch_classic_dpt import (  # noqa: F401
    CFG, INT8_TOL, Synth, _assert_frames_match, _frames, assert_trees_equal, jax_kernels,
    perturb, port_depth, rel)
from torch_threads import one_torch_thread  # noqa: F401

DEPTH = 2
ENCODERS = {name: enc for name, enc in T_inf.ENCODER_BY_NAME.items()}
INF_TOL = 1e-4  # f32 depth, port against JAX: max |port - JAX| / max |JAX|
MAP_TOL = 1e-5  # f32 module outputs (stem, head, tokens)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    """Every encoder cut to DEPTH blocks in both packages, widths kept."""
    with pytest.MonkeyPatch.context() as mp:
        for enc, (D, _, heads, ffn, swiglu) in J_inf.DINOV3_CONFIGS.items():
            cfg = (D, DEPTH, heads, ffn, swiglu)
            mp.setitem(J_inf.DINOV3_CONFIGS, enc, cfg)
            mp.setitem(T_inf.DINOV3_CONFIGS, enc, cfg)
        yield


@pytest.fixture(scope="module")
def inf(shallow):
    """registry name → (JAX params, port InfiniDepth) from one JAX init."""
    out = {}
    for i, (name, enc) in enumerate(ENCODERS.items()):
        params = perturb(jit_init(J_inf.InfiniDepth(encoder=enc),
                                  jnp.zeros((1, 64, 64, 3), jnp.float32), rng_seed=i),
                         seed=120 + i)
        model = T_inf.InfiniDepth(enc).eval()
        model.load_state_dict(from_flax(params), strict=True)
        out[name] = (params, model)
    return out


def rgb01(seed, h, w):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


def test_constants_equal_jax():
    assert T_inf.ENCODER_BY_NAME == J_inf.ENCODER_BY_NAME
    assert (T_inf.N_STORAGE_TOKENS, T_inf.PATCH) == (J_inf.N_STORAGE_TOKENS, J_inf.PATCH)
    np.testing.assert_array_equal(np.float32(T_inf.IMAGENET_MEAN), J_inf.IMAGENET_MEAN)
    np.testing.assert_array_equal(np.float32(T_inf.IMAGENET_STD), J_inf.IMAGENET_STD)
    assert T_inf.swiglu_width(2304) == 1536


@pytest.mark.parametrize("head_dim,gh,gw", [(64, 18, 32), (64, 12, 21), (64, 1, 1), (32, 3, 5)])
def test_rope_tables_equal_jax_exactly(head_dim, gh, gw):
    got = T_inf.dinov3_rope_tables(head_dim, gh, gw)
    want = J_inf._dinov3_rope_tables(head_dim, gh, gw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (gh * gw, head_dim)
        np.testing.assert_array_equal(g, w)


def test_rope_apply_matches_jax():
    gh, gw, hd = 3, 5, 64
    t = np.random.default_rng(1).standard_normal((2, 5 + gh * gw, 4, hd)).astype(np.float32)
    sin, cos = J_inf._dinov3_rope_tables(hd, gh, gw)
    want = np.asarray(J_inf._rope_apply(jnp.asarray(t), jnp.asarray(sin), jnp.asarray(cos), 5))
    ts, tc = T_inf._rope_on(hd, gh, gw, torch.device("cpu"), torch.float32)
    got = T_inf.rope_apply(torch.from_numpy(t), ts, tc)
    assert got.is_contiguous() and torch.equal(got[:, :5], torch.from_numpy(t[:, :5]))
    assert rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("hw", [(64, 96), (48, 80)])
def test_basic_encoder_matches_jax(inf, hw):
    params, model = inf["InfiniDepth-Small"]
    x = np.random.default_rng(2).standard_normal((1, *hw, 3)).astype(np.float32)
    tree = {"params": params["params"]["basic_encoder"]}
    want = np.asarray(J_inf.BasicEncoder().apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = model.basic_encoder(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, hw[0] // 4, hw[1] // 4, 128)
    assert rel(got, want) < MAP_TOL


@pytest.mark.parametrize("grid,out", [((3, 5), (48, 80)), ((4, 4), (64, 64)), ((2, 3), (32, 40))])
def test_implicit_head_matches_jax(inf, grid, out):
    """The zero-padding border mask (exactly) and the head on both maps."""
    np.testing.assert_array_equal(T_inf.zero_padding_mask(*grid, *out),
                                  J_inf._zero_padding_mask(*grid, *out))
    params, model = inf["InfiniDepth-Base"]
    rng = np.random.default_rng(3)
    dino = rng.standard_normal((1, *grid, 768)).astype(np.float32)
    basic = rng.standard_normal((1, out[0] // 4, out[1] // 4, 128)).astype(np.float32)
    want = np.asarray(J_inf.ImplicitHead().apply({"params": params["params"]["head"]},
                                                 jnp.asarray(dino), jnp.asarray(basic), out))
    with torch.no_grad():
        got = model.head(torch.from_numpy(dino), torch.from_numpy(basic), out).numpy()
    assert got.shape == want.shape == (1, *out) and rel(got, want) < MAP_TOL


@pytest.mark.parametrize("hw", [(64, 96), (48, 80)])
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_infinidepth_matches_jax(inf, name, hw):
    params, model = inf[name]
    x = rgb01(130 + hw[1], *hw)
    want = np.asarray(J_inf.InfiniDepth(encoder=ENCODERS[name]).apply(params, jnp.asarray(x)))
    got = port_depth(model, x)
    assert got.shape == want.shape == (1, *hw) and np.isfinite(got).all()
    assert rel(got, want) < INF_TOL


def test_attention_takes_rope_q_k_and_a_v_view(inf, monkeypatch):
    """q and k reach the attention as fresh contiguous [B, N, H, 64] tensors
    after the rotation; v as a strided view of the fused qkv product with a
    contiguous head dim: layouts the kernel reads without a copy."""
    _, model = inf["InfiniDepth-Large"]
    seen = []
    attend = T_inf.multi_head_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return attend(q, k, v, **kw)

    monkeypatch.setattr(T_inf, "multi_head_attention", spy)
    with torch.no_grad():
        model(torch.from_numpy(rgb01(5, 48, 80)))
    assert len(seen) == DEPTH
    for q, k, v in seen:
        assert q.shape == k.shape == v.shape == (1, 5 + 3 * 5, 16, 64)
        assert q.is_contiguous() and k.is_contiguous()
        assert not v.is_contiguous() and v.stride()[-1] == 1 and v.stride()[1] == 3 * 1024


# ---- the converter ----------------------------------------------------------------------------

def hf_infinidepth(name, seed, prefix=""):
    """A synthetic InfiniDepth checkpoint in the reference's naming at the
    encoder's real width and DEPTH blocks; `bias_mask` NaN on q and v, 0 on k."""
    s = Synth(seed)
    D, _, _, ffn, swiglu = J_inf.DINOV3_CONFIGS[ENCODERS[name]]
    bp = prefix + "pretrained."
    s.arr(bp + "cls_token", (1, 1, D))
    s.arr(bp + "storage_tokens", (1, 4, D))
    s.conv(bp + "patch_embed.proj", 3, D, 16)
    s.norm(bp + "norm", D)
    for i in range(DEPTH):
        lp = f"{bp}blocks.{i}."
        s.norm(lp + "norm1", D)
        s.norm(lp + "norm2", D)
        s.linear(lp + "attn.qkv", D, 3 * D)
        s.sd[lp + "attn.qkv.bias_mask"] = np.concatenate(
            [np.full(D, np.nan), np.zeros(D), np.full(D, np.nan)]).astype(np.float32)
        s.linear(lp + "attn.proj", D, D)
        s.arr(lp + "ls1.gamma", (D,), std=0.1, mean=1.0)
        s.arr(lp + "ls2.gamma", (D,), std=0.1, mean=1.0)
        if swiglu:
            sw = T_inf.swiglu_width(ffn)
            s.linear(lp + "mlp.w1", D, sw)
            s.linear(lp + "mlp.w2", D, sw)
            s.linear(lp + "mlp.w3", sw, D)
        else:
            s.linear(lp + "mlp.fc1", D, ffn)
            s.linear(lp + "mlp.fc2", ffn, D)
    be = prefix + "basic_encoder."
    s.conv(be + "conv1", 3, 64, 7)
    cin = 64
    for li, (w, stride) in enumerate(zip((64, 96, 128, 128), (1, 2, 2, 2)), 1):
        for bi in range(2):
            bl = f"{be}layer{li}.{bi}."
            s.conv(bl + "conv1", cin if bi == 0 else w, w, 3)
            s.conv(bl + "conv2", w, w, 3)
            if bi == 0 and stride != 1:
                s.conv(bl + "downsample.0", cin, w, 1)
        cin = w
    s.conv(be + "conv2", 416, 256, 3)
    s.conv(be + "conv3", 256, 128, 1)
    hp = prefix + "depth_implicit_head.out_layer.layers."
    for idx, (a, b) in zip((0, 2, 4, 6), ((D + 128, 1024), (1024, 256), (256, 32), (32, 1))):
        s.linear(f"{hp}{idx}", a, b)
    return s.sd


@pytest.mark.parametrize("name,prefix", [("InfiniDepth-SmallPlus", ""),
                                         ("InfiniDepth-Small", "model.")],
                         ids=["swiglu", "plain-model-prefix"])
def test_converter_gives_the_jax_tree(shallow, name, prefix, tmp_path):
    """The same numpy tree as the JAX converter, the k third of the qkv bias
    zeroed by the mask fold; `build_bound(..., checkpoint=)` loads it strict
    through the port's safetensors writer and reader, and runs the JAX
    model's depth."""
    sd = hf_infinidepth(name, seed=140, prefix=prefix)
    tree = T_convert.convert_infinidepth(sd, get_spec(name))
    want = J_convert.convert_infinidepth(sd, j_get_spec(name))
    assert_trees_equal(tree, want)
    D = J_inf.DINOV3_CONFIGS[ENCODERS[name]][0]
    bias = tree["backbone"]["layer_1"]["qkv"]["bias"]
    assert np.all(bias[D:2 * D] == 0) and np.all(bias[:D] != 0)
    path = tmp_path / "model.safetensors"
    save_file(sd, path)
    model, spec = factory.build_bound(name, device="cpu", checkpoint=str(path))
    x = rgb01(141, 48, 64)
    jd = np.asarray(J_inf.InfiniDepth(encoder=ENCODERS[name]).apply({"params": want},
                                                                    jnp.asarray(x)))
    assert rel(port_depth(model, x), jd) < INF_TOL


@pytest.mark.parametrize("name,per_layer", [("InfiniDepth-Large", 4), ("InfiniDepth-SmallPlus", 5)])
def test_int8_matches_jax(inf, name, per_layer):
    """The trunk's products int8 (qkv, proj, fc1/fc2 or w1/w2/w3), the stem
    and the head float: the port's quantisation equals the JAX tree's, and
    the int8 models agree."""
    params, model = inf[name]
    qtree = jax.tree.map(np.asarray, J_quant.quantize_tree(params))
    state = quantize_state_dict(model.state_dict())
    want = from_flax(qtree)
    assert set(state) == set(want)
    quantized = [k[: -len(".weight_q")] for k in want if k.endswith(".weight_q")]
    assert len(quantized) == per_layer * DEPTH
    assert all(k.startswith("backbone.layer.") for k in quantized)
    for k in quantized:
        assert torch.equal(state[k + ".weight_q"], want[k + ".weight_q"]), k
        assert torch.equal(state[k + ".scale"], want[k + ".scale"]), k
    qmodel = T_inf.InfiniDepth(ENCODERS[name], quant=True).eval()
    qmodel.load_state_dict(state, strict=True)
    assert sum(isinstance(m, QuantLinear) for m in qmodel.modules()) == per_layer * DEPTH
    x = rgb01(142, 48, 80)
    jq = J_inf.InfiniDepth(encoder=ENCODERS[name], quant=True)
    want_d = np.asarray(jax.jit(jq.apply)(qtree, jnp.asarray(x)))
    assert rel(port_depth(qmodel, x), want_d) < INT8_TOL


def test_stem_stays_f32_under_a_bf16_model(inf):
    """`.to(bfloat16)` casts the trunk and the head, not the conv stem; the
    bf16 model tracks the f32 one."""
    _, model = inf["InfiniDepth-Small"]
    half = T_inf.InfiniDepth("vits16").eval()
    half.load_state_dict(model.state_dict())
    half = half.to(torch.bfloat16)
    assert isinstance(half.basic_encoder, F32Module)
    assert {p.dtype for p in half.basic_encoder.parameters()} == {torch.float32}
    assert half.backbone.layer[0].qkv.weight.dtype == torch.bfloat16
    x = torch.from_numpy(rgb01(6, 48, 80))
    with torch.no_grad():
        got = half(x.to(torch.bfloat16)).float()
        want = model(x)
    assert got.shape == want.shape and rel(got.numpy(), want.numpy()) < 0.1


def test_f32_module_keeps_its_device_through_a_dtype_cast():
    """A model moved and cast in one call, then cast again by dtype alone
    (`.to(bfloat16)`, `.half()`, `.float()`): the f32 stem stays f32 and on
    the model's device (the meta device here; a stem sent back to the CPU
    would raise, as meta tensors hold no data)."""
    model = T_inf.InfiniDepth("vits16").to(device="meta", dtype=torch.bfloat16)
    for cast in (lambda m: m, lambda m: m.to(torch.bfloat16), lambda m: m.half(),
                 lambda m: m.float()):
        model = cast(model)
        assert {p.device.type for p in model.parameters()} == {"meta"}
        assert {p.dtype for p in model.basic_encoder.parameters()} == {torch.float32}
    assert model.backbone.layer[0].qkv.weight.dtype == torch.float32
    assert model.half().backbone.layer[0].qkv.weight.dtype == torch.float16

# ---- the frame program -------------------------------------------------------------------------

def test_program_cache_matches_jax(inf, jax_kernels):  # noqa: F811
    """Three 180x320 frames through both ProgramCaches (InfiniDepth-Small,
    norm family "none": the model normalises RGB in [0, 1] itself),
    Half-SBS switched live to Half-TAB: frames and depth at the pipeline
    thresholds; a stateless model carries no model state."""
    name = "InfiniDepth-Small"
    params, model = inf[name]
    cfg = dict(CFG, model_name=name, display_mode="Half-SBS")
    jm = J_inf.InfiniDepth(encoder=ENCODERS[name])
    jprog = J_programs.ProgramCache(J_programs.ProgramConfig(**cfg),
                                    J_programs.BoundModel.stateless(jm.apply, params),
                                    j_get_spec(name), compute_dtype=jnp.float32)
    tprog = T_programs.ProgramCache(T_programs.ProgramConfig(**cfg), model, get_spec(name),
                                    compute_dtype=torch.float32)
    for i, frame in enumerate(_frames(3)):
        if i == 1:
            jprog.set_display_mode("Half-TAB")
            tprog.set_display_mode("Half-TAB")
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
        assert tprog._states[(0, 180, 320)].model == ()


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_build_bound_builds_infinidepth(shallow, name, quant, monkeypatch):
    """Each registry name through `build_bound` on the CPU, seeded, at its
    real width and DEPTH blocks: int8 on the trunk's products (5 a block
    for SmallPlus's SwiGLU, 4 otherwise), the stem f32, depth at the input's
    size."""
    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", ())
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    model, spec = factory.build_bound(name, device="cpu", quant=quant)
    assert spec.norm_family == "none" and spec.patch_size == 16
    quantized = [n for n, m in model.named_modules() if isinstance(m, QuantLinear)]
    per_layer = 5 if name == "InfiniDepth-SmallPlus" else 4
    assert len(quantized) == (per_layer * DEPTH if quant == "int8" else 0)
    assert all(n.startswith("backbone.layer.") for n in quantized)
    with torch.no_grad():
        d = model(torch.from_numpy(rgb01(7, 32, 48)))
    assert d.shape == (1, 32, 48) and bool(torch.isfinite(d).all())


def test_batch_of_two_equals_each_image_alone(inf):
    """The batched multi-stream program runs the model at batch S
    (`BatchedProgramCache`): each row of a batch of two equals that image
    alone, within INF_TOL."""
    _, model = inf[sorted(ENCODERS)[0]]
    x = np.concatenate([rgb01(131, 48, 80), rgb01(132, 48, 80)])
    got = port_depth(model, x)
    assert got.shape == (2, 48, 80)
    for s in range(2):
        assert rel(got[s:s + 1], port_depth(model, x[s:s + 1])) < INF_TOL
