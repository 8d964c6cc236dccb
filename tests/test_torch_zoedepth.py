"""The port's ZoeDepth (`models/zoedepth.py`) against the JAX package's, on
the CPU in f32: the single- and multi-head presets, the domain vote taking
each branch, `first` / `step` with the carried tables (expanded, equal to
JAX's dense biases), the converter, the int8 form, the metric head kept in
f32 under a bf16 trunk, and one frame program.

The trunk is cut to a tiny BEiT preset (pretraining window 4) patched into
both packages' `BEIT_PRESETS["zoedepth"]`; the heads keep their real widths
(128-wide bin embeddings and patch transformer).  Weights come from the JAX
module's init, every leaf moved by seeded noise so that no bias, table or
norm stays at its initial value, and carried to the port by `from_flax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn

import desktop2stereo_tpu.models.beit as J_beit
import desktop2stereo_tpu.models.zoedepth as J_zoe
import desktop2stereo_tpu.ops.quant as J_quant
import desktop2stereo_tpu.pipeline.programs as J_programs
from desktop2stereo_tpu.core.registry import get_spec as j_get_spec
from desktop2stereo_tpu.models import convert_hf as J_convert
from desktop2stereo_tpu.models.init_util import jit_init
from desktop2stereo_tpu.ops.activations import gelu as J_gelu
import desktop2stereo_tpu_torch.core.registry as T_reg
import desktop2stereo_tpu_torch.models.beit as T_beit
import desktop2stereo_tpu_torch.models.zoedepth as T_zoe
from desktop2stereo_tpu_torch.models import convert_hf as T_convert
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.models.safetensors_io import save_file
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, quantize_state_dict
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from torch_classic_dpt import (  # noqa: F401
    CFG, F32_TOL, FUSION, INT8_TOL, NECK, Synth, _assert_frames_match, _frames,
    assert_trees_equal, hf_beit_dpt, jax_kernels, perturb, pixels, port_depth, rel)
from torch_threads import one_torch_thread  # noqa: F401

WINDOW, LAYERS, HEADS, D = 4, 4, 4, 64
TINY_TRUNK = (D, LAYERS, HEADS, 128, (0, 1, 2, 3), WINDOW)
NAMES = ("zoedepth-nyu", "zoedepth-nyu-kitti")
# f32 depth, port against JAX (max |port - JAX| / max |JAX|): the metric head's
# tempered softmax over 64 bins amplifies f32 rounding about tenfold over
# DPT-BEiT's 1e-5 (the JAX package's own ZoeDepth test holds 5e-4 against HF)
ZOE_TOL = 1e-4
JIT_TOL = 1e-4  # jitted JAX against eager JAX: XLA's fusions reorder the f32 rounding


@pytest.fixture(scope="module", autouse=True)
def tiny_trunk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_beit.BEIT_PRESETS, "zoedepth", TINY_TRUNK)
        mp.setitem(T_beit.BEIT_PRESETS, "zoedepth", TINY_TRUNK)
        yield


def _jmodel(name, quant=False):
    return J_zoe.ZoeDepth(preset=name, neck_channels=NECK, fusion_channels=FUSION, quant=quant)


def _tmodel(name, quant=False):
    return T_zoe.ZoeDepth(name, NECK, FUSION, quant=quant).eval()


@pytest.fixture(scope="module")
def zoe(tiny_trunk):
    """name → (JAX params, port ZoeDepth) from one JAX init per preset."""
    out = {}
    for i, name in enumerate(NAMES):
        params = perturb(jit_init(_jmodel(name), jnp.zeros((1, 64, 64, 3), jnp.float32),
                                  rng_seed=i), seed=40 + i)
        model = _tmodel(name)
        model.load_state_dict(from_flax(params), strict=True)
        out[name] = (params, model)
    return out


class _HostLogBinomial(J_zoe.ConditionalLogBinomial):
    """The JAX ConditionalLogBinomial with its constant log-binomial term
    over the bins computed on the host in f32, the value the eager JAX
    module computes.  Under jit, XLA folds log(n - (k+e) + e) at k = n into
    the log of 0 and the term into 0·(-inf) = NaN, so every jitted JAX
    ZoeDepth returns NaN on the CPU (ROADMAP C7); the tests that need JAX
    under jit (int8, whose rounding JAX folds only under jit, and the frame
    program) run with this class patched in."""

    @nn.compact
    def __call__(self, main, cond):
        mid = (self.in_features + self.condition_dim) // self.bottleneck_factor
        h = jnp.concatenate([main, cond], axis=-1)
        h = nn.Conv(mid, (1, 1), name="mlp_conv1", dtype=h.dtype)(h)
        h = nn.Conv(4, (1, 1), name="mlp_conv2", dtype=h.dtype)(J_gelu(h))
        h = jax.nn.softplus(h)
        p = h[..., :2] + 1e-4
        prob = p[..., 0] / (p[..., 0] + p[..., 1])
        t = h[..., 2:] + 1e-4
        temp = t[..., 0] / (t[..., 0] + t[..., 1])
        temp = (J_zoe.MAX_TEMP - J_zoe.MIN_TEMP) * temp + J_zoe.MIN_TEMP
        prob = jnp.clip(prob, 1e-4, 1.0)[..., None]
        one_minus = jnp.clip(1.0 - prob, 1e-4, 1.0)
        f32 = np.float32
        e, n1 = f32(1e-7), f32(self.n_bins - 1)
        kk = np.arange(self.n_bins, dtype=f32)
        n, kke = n1 + e, kk + e
        const = n * np.log(n) - kke * np.log(kke) - (n - kke) * np.log(n - kke + e)
        k = jnp.arange(self.n_bins, dtype=jnp.float32)
        y = jnp.asarray(const) + k * jnp.log(prob) + (n1 - k) * jnp.log(one_minus)
        return jax.nn.softmax(y / temp[..., None], axis=-1)


@pytest.fixture
def jit_safe_zoe(monkeypatch):
    monkeypatch.setattr(J_zoe, "ConditionalLogBinomial", _HostLogBinomial)


def _jax_depth(name, params, x, jmodel=None, jit=False):
    """The JAX model's depth, eager (as the JAX package's own ZoeDepth test
    runs it) or jitted (with `jit_safe_zoe`)."""
    jm = jmodel or _jmodel(name)
    fn = jax.jit(jm.apply) if jit else jm.apply
    return np.asarray(fn(params, jnp.asarray(x)))


def test_jitted_jax_needs_the_host_term(zoe, monkeypatch):
    """Jitted, the JAX module returns NaN everywhere; with the host term
    patched in it equals the eager module."""
    params, _ = zoe["zoedepth-nyu"]
    x = pixels(49, 64, 64)
    eager = _jax_depth("zoedepth-nyu", params, x)
    assert np.isfinite(eager).all()
    assert np.isnan(_jax_depth("zoedepth-nyu", params, x, jit=True)).all()
    monkeypatch.setattr(J_zoe, "ConditionalLogBinomial", _HostLogBinomial)
    assert rel(_jax_depth("zoedepth-nyu", params, x, jit=True), eager) < JIT_TOL


@pytest.mark.parametrize("hw", [(64, 64), (96, 128), (48, 80)],
                         ids=["pretrain-window", "6x8", "3x5"])
@pytest.mark.parametrize("name", NAMES)
def test_zoedepth_matches_jax(zoe, name, hw):
    params, model = zoe[name]
    x = pixels(50 + hw[1], *hw)
    want = _jax_depth(name, params, x)
    got = port_depth(model, x)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel(got, want) < ZOE_TOL


@pytest.mark.parametrize("branch", [0, 1])
def test_domain_vote_takes_each_branch(zoe, branch):
    """The classifier's last bias forced towards one domain: the port picks
    the same branch as JAX on the device, and the two branches differ."""
    params, _ = zoe["zoedepth-nyu-kitti"]
    forced = jax.tree.map(np.array, params)
    fc2 = forced["params"]["metric_head"]["classifier_fc2"]
    fc2["bias"] = np.array([50.0, -50.0] if branch == 0 else [-50.0, 50.0], np.float32)
    model = _tmodel("zoedepth-nyu-kitti")
    model.load_state_dict(from_flax(forced), strict=True)
    x = pixels(61, 64, 96)
    want = _jax_depth("zoedepth-nyu-kitti", forced, x)
    got = port_depth(model, x)
    assert rel(got, want) < ZOE_TOL
    other = jax.tree.map(np.array, forced)
    other["params"]["metric_head"]["classifier_fc2"]["bias"] = fc2["bias"][::-1].copy()
    model.load_state_dict(from_flax(other), strict=True)
    assert rel(port_depth(model, x), got) > 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_first_and_step_carry_the_tables_as_jax(zoe, name):
    """`first` builds the layers' [H, R] tables once and `step` hands the
    same tensors back; the frames equal JAX's stream functions and the
    plain forward, and the tables, expanded, JAX's carried dense biases."""
    params, model = zoe[name]
    first, step = J_zoe.make_zoe_stream_fns(_jmodel(name), j_get_spec(name))
    x0, x1 = pixels(62, 48, 96), pixels(63, 48, 96)
    jd0, jcarry = first(params, jnp.asarray(x0))
    jd1, _ = step(params, jnp.asarray(x1), jcarry)
    with torch.no_grad():
        td0, carry = model.first(torch.from_numpy(x0))
        td1, carry1 = model.step(torch.from_numpy(x1), carry)
        plain = model(torch.from_numpy(x1))
    assert rel(td0.numpy(), jd0) < ZOE_TOL and rel(td1.numpy(), jd1) < ZOE_TOL
    assert torch.equal(td1, plain) and carry1 is carry
    assert len(carry) == len(jcarry) == LAYERS
    for c, jc in zip(carry, jcarry):
        assert c.shape == (HEADS, 5 * 11 + 3) and c.is_contiguous()
        assert rel(T_beit.expand_rel_pos(c, 3, 6).numpy(), jc) < F32_TOL


@pytest.mark.parametrize("grid", [(4, 4), (14, 24), (18, 32)], ids=["window", "14x24", "18x32"])
def test_expanded_tables_equal_jax_biases(zoe, grid):
    """The tables interpolated from the 4x4 window, at the grids a 4K frame
    gives at 384 and 512, equal JAX's `compute_rel_pos_biases`."""
    params, model = zoe["zoedepth-nyu"]
    want = J_beit.compute_rel_pos_biases(params["params"]["backbone"], *grid, WINDOW,
                                         LAYERS, HEADS)
    with torch.no_grad():
        got = T_beit.compute_rel_pos_tables(model.backbone, *grid)
    for g, w in zip(got, want):
        assert rel(T_beit.expand_rel_pos(g, *grid).numpy(), w) < F32_TOL


# ---- the converter ----------------------------------------------------------------------------

def hf_zoedepth(name, seed):
    """A synthetic HF ZoeDepthForDepthEstimation state dict at the tiny
    widths: the BEiT trunk and neck of `hf_beit_dpt`, the relative head and
    the metric head of the preset."""
    s = Synth(seed)
    s.sd.update({k: v for k, v in hf_beit_dpt(seed, D, LAYERS, HEADS, 128, WINDOW).items()
                 if not k.startswith("head.")})
    for n, (cin, cout, k) in (("conv1", (FUSION, FUSION // 2, 3)),
                              ("conv2", (FUSION // 2, 32, 3)), ("conv3", (32, 1, 1))):
        s.conv(f"relative_head.{n}", cin, cout, k)
    configs, multi = T_zoe.ZOE_PRESETS[name]
    m = "metric_head."
    mlp = 64 if multi else 128

    def proj(prefix, cin, cout, mid):
        s.conv(prefix + "conv1", cin, mid, 1)
        s.conv(prefix + "conv2", mid, cout, 1)

    s.conv(m + "conv2", FUSION, FUSION, 1)
    proj(m + "seed_projector.", FUSION, 128, mlp)
    for i in range(4):
        proj(f"{m}projectors.{i}.", FUSION, 128, mlp)
    if not multi:
        proj(m + "seed_bin_regressor.", FUSION, 64, 256)
        for i, n in enumerate(T_zoe.N_ATTRACTORS):
            proj(f"{m}attractors.{i}.", 128, n, 128)
        s.conv(m + "conditional_log_binomial.mlp.0", 33 + 128, (33 + 128) // 2, 1)
        s.conv(m + "conditional_log_binomial.mlp.2", (33 + 128) // 2, 4, 1)
        return s.sd
    for cname, n_bins, *_ in configs:
        proj(f"{m}seed_bin_regressors.{cname}.", FUSION, n_bins, 64)
        for i in range(4):
            proj(f"{m}attractors.{cname}.{i}.", 128, 16, 128)
        s.conv(f"{m}conditional_log_binomial.{cname}.mlp.0", 160, 40, 1)
        s.conv(f"{m}conditional_log_binomial.{cname}.mlp.2", 40, 4, 1)
    s.conv(m + "patch_transformer.embedding_convPxP", FUSION, 128, 1)
    for li in range(4):
        tp = f"{m}patch_transformer.transformer_encoder.{li}."
        for n in ("query", "key", "value", "out_proj"):
            s.linear(tp + "self_attn." + n, 128, 128)
        s.linear(tp + "linear1", 128, 1024)
        s.linear(tp + "linear2", 1024, 128)
        s.norm(tp + "norm1", 128)
        s.norm(tp + "norm2", 128)
    s.linear(m + "mlp_classifier.linear1", 128, 128)
    s.linear(m + "mlp_classifier.linear2", 128, 2)
    return s.sd


@pytest.mark.parametrize("name", NAMES)
def test_converter_gives_the_jax_tree(name, tmp_path, monkeypatch):
    """The same numpy tree as the JAX converter (keys, shapes, values), the
    multi-head keys included; then `build_bound(..., checkpoint=)` loads it
    strict through the port's safetensors writer and reader, and the loaded
    model runs the JAX model's depth."""
    import desktop2stereo_tpu_torch.models.factory as factory

    sd = hf_zoedepth(name, seed=70)
    tree = T_convert.convert_zoedepth(sd, T_reg.get_spec(name))
    want = J_convert.convert_zoedepth(sd, j_get_spec(name))
    assert_trees_equal(tree, want)
    assert ("patch_transformer" in tree["metric_head"]) == (name == "zoedepth-nyu-kitti")
    path = tmp_path / "model.safetensors"
    save_file(sd, path)
    monkeypatch.setitem(T_reg.NECK_CHANNELS, "vitl", NECK)
    monkeypatch.setitem(T_reg.FUSION_CHANNELS, "vitl", FUSION)
    model, spec = factory.build_bound(name, device="cpu", checkpoint=str(path))
    assert isinstance(model, T_zoe.ZoeDepth) and spec.name == name
    x = pixels(71, 64, 96)
    assert rel(port_depth(model, x), _jax_depth(name, {"params": want}, x)) < ZOE_TOL


def test_int8_matches_jax(zoe, jit_safe_zoe):
    """The trunk's six products a layer int8, the heads (the patch
    transformer's fc1/fc2 among them) float: the port's quantisation equals
    the JAX tree's, and the int8 models agree."""
    name = "zoedepth-nyu-kitti"
    params, model = zoe[name]
    qtree = jax.tree.map(np.asarray, J_quant.quantize_tree(params))
    state = quantize_state_dict(model.state_dict())
    want = from_flax(qtree)
    assert set(state) == set(want)
    quantized = [k[: -len(".weight_q")] for k in want if k.endswith(".weight_q")]
    assert len(quantized) == 6 * LAYERS and all(k.startswith("backbone.") for k in quantized)
    for k in quantized:
        assert torch.equal(state[k + ".weight_q"], want[k + ".weight_q"]), k
        assert torch.equal(state[k + ".scale"], want[k + ".scale"]), k
    assert state["metric_head.patch_transformer.fc1.0.weight"].dtype == torch.float32
    qmodel = _tmodel(name, quant=True)
    qmodel.load_state_dict(state, strict=True)
    assert sum(isinstance(m, QuantLinear) for m in qmodel.modules()) == 6 * LAYERS
    x = pixels(72, 48, 80)
    want_d = _jax_depth(name, qtree, x, _jmodel(name, quant=True), jit=True)
    assert rel(port_depth(qmodel, x), want_d) < INT8_TOL


def test_metric_head_stays_f32_under_a_bf16_trunk(zoe):
    """`.to(bfloat16)` casts the trunk and decoder, not the metric head,
    whose output stays f32 and tracks the f32 model."""
    _, model = zoe["zoedepth-nyu-kitti"]
    half = _tmodel("zoedepth-nyu-kitti")
    half.load_state_dict(model.state_dict())
    half = half.to(torch.bfloat16)
    assert half.backbone.layer[0].query.weight.dtype == torch.bfloat16
    assert {p.dtype for p in half.metric_head.parameters()} == {torch.float32}
    x = torch.from_numpy(pixels(73, 64, 96))
    with torch.no_grad():
        got = half(x.to(torch.bfloat16))
        want = model(x)
    assert got.dtype == torch.float32 and rel(got.numpy(), want.numpy()) < 0.1


# ---- the frame program -------------------------------------------------------------------------

def test_program_cache_matches_jax(zoe, jax_kernels, jit_safe_zoe):  # noqa: F811
    """first → step → step on 180x320 frames through both ProgramCaches
    (JAX's with its zoe stream functions), switched live from Half-SBS to
    Half-TAB after the first: frames and depth at the pipeline thresholds,
    the carry built once and kept."""
    name = "zoedepth-nyu-kitti"
    params, model = zoe[name]
    spec = j_get_spec(name)
    first, step = J_zoe.make_zoe_stream_fns(_jmodel(name), spec)
    cfg = dict(CFG, model_name=name, display_mode="Half-SBS")
    jprog = J_programs.ProgramCache(J_programs.ProgramConfig(**cfg),
                                    J_programs.BoundModel(params=params, first=first, step=step),
                                    spec, compute_dtype=jnp.float32)
    tprog = T_programs.ProgramCache(T_programs.ProgramConfig(**cfg), model,
                                    T_reg.get_spec(name), compute_dtype=torch.float32)
    kept = None
    for i, frame in enumerate(_frames(3)):
        if i == 1:
            jprog.set_display_mode("Half-TAB")
            tprog.set_display_mode("Half-TAB")
        j_sbs, j_depth = (np.asarray(a) for a in jprog(jnp.asarray(frame)))
        t_sbs, t_depth = (a.numpy() for a in tprog(frame))
        _assert_frames_match(j_sbs, j_depth, t_sbs, t_depth)
        carry = tprog._states[(0, 180, 320)].model
        assert len(carry) == LAYERS and (kept is None or carry is kept)
        kept = carry


def test_batched_program_takes_a_stale_row_with_one_set_of_tables(zoe, jax_kernels,  # noqa: F811
                                                                   jit_safe_zoe):
    """Two streams through the port's BatchedProgramCache, the second row
    stale on step 2 (where JAX's batched cache raises, ROADMAP C9), each row
    against a JAX per-stream ProgramCache fed that row's frames; the carry is
    one set of tables for the batch, built once and never masked."""
    from test_torch_beit import _stale_steps

    name = "zoedepth-nyu-kitti"
    params, model = zoe[name]
    spec = j_get_spec(name)
    first, step = J_zoe.make_zoe_stream_fns(_jmodel(name), spec)
    cfg = dict(CFG, model_name=name, display_mode="Half-SBS")
    jprog = J_programs.ProgramCache(J_programs.ProgramConfig(**cfg),
                                    J_programs.BoundModel(params=params, first=first, step=step),
                                    spec, compute_dtype=jnp.float32)
    tprog = T_programs.BatchedProgramCache(T_programs.ProgramConfig(**cfg), model,
                                           T_reg.get_spec(name), compute_dtype=torch.float32,
                                           num_streams=2)
    carry = _stale_steps(tprog, lambda frame, s: jprog(jnp.asarray(frame), stream=s))
    assert len(carry) == LAYERS and all(c.ndim == 2 and c.shape[0] == HEADS for c in carry)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("name", ["zoedepth-nyu", "zoedepth-kitti", "zoedepth-nyu-kitti"])
def test_build_bound_builds_zoedepth(name, quant, monkeypatch):
    """Each registry name through `build_bound` on the CPU, seeded, at the
    tiny trunk and neck: stateful (first, then step with the carried
    tables); int8 on the trunk's six products a layer, the metric head (the
    patch transformer's Linears among it) float and f32."""
    import desktop2stereo_tpu_torch.models.factory as factory

    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", ())
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    monkeypatch.setitem(T_reg.NECK_CHANNELS, "vitl", NECK)
    monkeypatch.setitem(T_reg.FUSION_CHANNELS, "vitl", FUSION)
    model, spec = factory.build_bound(name, device="cpu", quant=quant)
    assert isinstance(model, T_zoe.ZoeDepth) and spec.metric
    quantized = [n for n, m in model.named_modules() if isinstance(m, QuantLinear)]
    assert len(quantized) == (6 * LAYERS if quant == "int8" else 0)
    assert all(n.startswith("backbone.") for n in quantized)
    assert {p.dtype for p in model.metric_head.parameters()} == {torch.float32}
    x = torch.from_numpy(pixels(74, 64, 96))
    with torch.no_grad():
        d0, carry = model.first(x)
        d1, carry1 = model.step(x, carry)
    assert carry1 is carry and len(carry) == LAYERS and torch.equal(d0, d1)
    assert d0.shape == (1, 64, 96) and bool(torch.isfinite(d0).all())
