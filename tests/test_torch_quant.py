"""The port's int8 encoder path against the JAX package's, on the CPU.

Quantisation helpers, the K4 plain version (`quant_dense_ref`), QuantLinear,
`quantize_state_dict`, `from_flax` of a quantized tree, a tiny int8
Depth-Anything and `build_bound(quant="int8")`.  Inputs are drawn with numpy
from a seed.  The JAX functions run as the JAX model runs them: under jit,
where XLA folds the division by 127 into a multiply by its f32 reciprocal
and contracts the epilogue into a fused multiply-add (weights are quantized
eagerly, by IEEE division, in the JAX factory).  The JAX `QuantDense` swallows
a kernel failure and takes `xla_quant_dense`, so the run through the Pallas
kernel patches the dispatch and counts the kernel's calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.ops.pallas.quant_matmul as J_qm
import desktop2stereo_tpu.ops.quant as J_quant
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.factory import build_bound
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.ops import quant as T_quant
from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K_qm
from desktop2stereo_tpu_torch.ops.kernels.quant_matmul import quant_dense, quant_dense_ref
from torch_threads import one_torch_thread  # noqa: F401

# hd 64 and K a multiple of 128: shapes the JAX kernel's `supported` takes
TINY_Q = dict(hidden_size=128, num_layers=4, num_heads=2, mlp_dim=256,
              out_layers=(0, 1, 2, 3), neck_channels=(16, 32, 64, 64),
              fusion_channels=32)
MODEL_REL_TOL = 1e-2  # int8 port vs int8 JAX on the same quantized tree


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _row_scaled(rng, shape):
    """Normal activations whose rows span four decades of magnitude, one row
    all zero (the clamped scale)."""
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-2, 2, shape[:-1] + (1,))
    x.reshape(-1, shape[-1])[0] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("K,F", [(64, 32), (256, 272)])
def test_quantize_weight_matches_jax(K, F):
    rng = np.random.default_rng(K + F)
    w = (rng.standard_normal((K, F)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    jq, js = J_quant.quantize_weight(jnp.asarray(w))
    tq, ts = T_quant.quantize_weight(_t(w.T))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dynamic_quantize_matches_jax():
    rng = np.random.default_rng(1)
    for i in range(20):
        x = (rng.standard_normal((7, 33)) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
        jq, js = jax.jit(J_quant.dynamic_quantize)(jnp.asarray(x))
        tq, ts = T_quant.dynamic_quantize(_t(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.dtype == torch.float32 and ts.item() == float(js), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_quantize_rows_matches_jax(dtype):
    x = _row_scaled(np.random.default_rng(2), (2000, 96))
    jx = jnp.asarray(x, dtype)
    jq, js = jax.jit(J_quant.dynamic_quantize_rows)(jx)
    tq, ts = T_quant.dynamic_quantize_rows(_t(np.asarray(jx.astype(jnp.float32)),
                                              getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.shape == (2000, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _dense_case(seed, lead, K, F, dtype, with_bias):
    """(JAX args, port args) of one quantized dense layer."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(_row_scaled(rng, lead + (K,)) * 0.5, dtype)
    wq, ws = J_quant.quantize_weight(jnp.asarray(rng.standard_normal((K, F)) * 0.05,
                                                 jnp.float32))
    b = jnp.asarray(rng.standard_normal(F) * 0.1, jnp.float32) if with_bias else None
    tx = _t(np.asarray(x.astype(jnp.float32)), getattr(torch, jnp.dtype(dtype).name))
    targs = (tx, _t(np.asarray(wq).T), _t(np.asarray(ws)), None if b is None else _t(b))
    return (x, wq, ws, b), targs


@pytest.mark.parametrize("lead", [(300,), (2, 129)], ids=["rows", "lead-dims"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quant_dense_ref_matches_jax_exactly(lead, with_bias, dtype):
    """The plain K4 equals `xla_quant_dense` and the interpret-mode Pallas
    kernel bit for bit."""
    jargs, targs = _dense_case(3, lead, 256, 272, dtype, with_bias)
    got = quant_dense(*targs)  # CPU tensors: the wrapper takes the plain version
    assert got.dtype == targs[0].dtype and got.shape == lead + (272,)
    got = got.float().numpy()
    want = np.asarray(jax.jit(J_quant.xla_quant_dense)(*jargs).astype(jnp.float32))
    kern = np.asarray(J_qm.quant_dense_matmul(*jargs, interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kern)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quant_dense_ref_row_scale_mode_matches_jax_kernel(dtype):
    """Caller-given row scales (twice the rows' own, as a wider-K shard's
    abs-max would give) against the interpret-mode kernel."""
    jargs, targs = _dense_case(4, (96,), 256, 384, dtype, True)
    x = jargs[0].astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-8) / 127.0 * 2.0
    got = quant_dense_ref(*targs, row_scale=_t(np.asarray(sx))).float().numpy()
    kern = J_qm.quant_dense_matmul(*jargs, row_scale=sx, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(kern.astype(jnp.float32)))


def test_quant_dense_ref_int32_mode_is_exact():
    """Raw accumulators equal the interpret-mode kernel's and an exact int64
    product of the quantized activations."""
    rng = np.random.default_rng(6)
    M, K, F = 64, 128, 256
    x = (rng.standard_normal((M, K)) * 0.5).astype(np.float32)
    wq = rng.integers(-127, 128, (K, F)).astype(np.int8)
    sx = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8)) / np.float32(127)
    got = quant_dense_ref(_t(x), _t(wq.T), torch.ones(F), row_scale=_t(sx),
                          out_dtype=torch.int32)
    assert got.dtype == torch.int32
    kern = J_qm.quant_dense_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.ones((F,), jnp.float32),
                                   row_scale=jnp.asarray(sx), interpret=True,
                                   out_dtype=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    xq = np.clip(np.round(x / sx), -127, 127).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), xq @ wq.astype(np.int64))


def test_quant_linear_keeps_f32_buffers_through_to():
    """`.to(bf16)` casts float parameters; QuantLinear's int8 weight and its
    f32 scale and bias stay as they were, bit for bit."""
    rng = np.random.default_rng(7)
    lin = T_quant.QuantLinear(64, 48)
    lin.weight_q.copy_(_t(rng.integers(-127, 128, (48, 64)).astype(np.int8)))
    lin.scale.copy_(_t(rng.random(48).astype(np.float32) * 1e-3 + 1e-4))
    lin.bias.copy_(_t(rng.standard_normal(48).astype(np.float32)))
    before = {k: v.clone() for k, v in lin.state_dict().items()}
    model = torch.nn.Sequential(torch.nn.Linear(64, 64), lin).to(torch.bfloat16)
    assert model[0].weight.dtype == torch.bfloat16
    for k, v in lin.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    assert lin.double().scale.dtype == torch.float32 and lin.weight_q.dtype == torch.int8
    y = model(torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)).bfloat16())
    assert y.dtype == torch.bfloat16 and y.shape == (5, 48)
    nobias = T_quant.QuantLinear(64, 8, bias=False).to(torch.bfloat16)
    assert nobias.bias is None and nobias.scale.dtype == torch.float32


def test_quantize_state_dict_scopes_to_backbone():
    """Only the named dense layers BENEATH the backbone convert; a neck
    `proj` and a head `fc1` stay float."""
    w = torch.ones(4, 8)
    state = {"backbone.layer.0.attention.qkv.weight": w, "backbone.layer.0.attention.qkv.bias": torch.zeros(4),
             "backbone.layer.0.attention.proj.weight": w, "backbone.layer.0.norm1.weight": torch.ones(8),
             "backbone.embeddings.patch_embeddings.weight": w,
             "neck.proj.weight": w, "neck.proj.bias": torch.zeros(4), "head.fc1.weight": w}
    out = T_quant.quantize_state_dict(state)
    for m in ("backbone.layer.0.attention.qkv", "backbone.layer.0.attention.proj"):
        assert out[f"{m}.weight_q"].dtype == torch.int8 and f"{m}.weight" not in out
        assert out[f"{m}.scale"].dtype == torch.float32
    assert out["backbone.layer.0.attention.qkv.bias"].dtype == torch.float32
    for k in ("backbone.layer.0.norm1.weight", "backbone.embeddings.patch_embeddings.weight",
              "neck.proj.weight", "neck.proj.bias", "head.fc1.weight"):
        assert out[k] is state[k], k
    multi = T_quant.quantize_state_dict({"patch_encoder.l.fc1.weight": w,
                                         "decoder.fc1.weight": w},
                                        scope=("patch_encoder", "image_encoder"))
    assert set(multi) == {"patch_encoder.l.fc1.weight_q", "patch_encoder.l.fc1.scale",
                          "decoder.fc1.weight"}


def _seeded_params(module, sample, seed=0):
    """Float flax parameters of `module`, drawn with numpy from a seed:
    fan-in scaled normal kernels, unit norm and layer scales, small normal
    biases and embeddings."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), sample))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale" or name.startswith("layer_scale"):
            return np.ones(leaf.shape, np.float32)
        std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if name == "kernel" else 0.02
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def tiny_q():
    """(quantized JAX tree, the port's int8 model loaded from it)."""
    params = _seeded_params(JDepthAnything(**TINY_Q), jnp.zeros((1, 28, 42, 3), jnp.float32))
    qparams = jax.tree.map(np.asarray, J_quant.quantize_tree(params))
    model = DepthAnything(**TINY_Q, quant=True).eval()
    model.load_state_dict(from_flax(qparams), strict=True)
    return qparams, model


def test_from_flax_loads_a_quantized_tree(tiny_q):
    qparams, model = tiny_q
    sd = model.state_dict()
    dense = qparams["params"]["backbone"]["layer_2"]["mlp"]["fc1"]
    assert set(dense) == {"kernel_q", "scale", "bias"}
    got = sd["backbone.layer.2.mlp.fc1.weight_q"]
    assert got.dtype == torch.int8 and got.shape == (256, 128) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), dense["kernel_q"].T)
    np.testing.assert_array_equal(sd["backbone.layer.2.mlp.fc1.scale"].numpy(), dense["scale"])
    np.testing.assert_array_equal(sd["backbone.layer.2.mlp.fc1.bias"].numpy(), dense["bias"])
    ln = qparams["params"]["backbone"]["layer_2"]["norm1"]["scale"]
    np.testing.assert_array_equal(sd["backbone.layer.2.norm1.weight"].numpy(), ln)
    quantized = [n for n, m in model.named_modules() if isinstance(m, T_quant.QuantLinear)]
    assert len(quantized) == 16 and all(n.startswith("backbone.layer.") for n in quantized)


class _Counted:
    """The JAX Pallas K4 in interpret mode, counting its calls."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, *args, **kw):
        out = self.fn(*args, **dict(kw, interpret=True))
        self.calls += 1
        return out


def _jax_depth(params, x, quant=True):
    jmodel = JDepthAnything(**TINY_Q, quant=quant)
    # a fresh function: each call traces (and so dispatches) anew
    return np.asarray(jax.jit(lambda p, a: jmodel.apply(p, a))(params, jnp.asarray(x)))


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("jax_path", ["xla", "pallas-interpret"])
def test_tiny_int8_model_matches_jax(tiny_q, monkeypatch, jax_path):
    """The same quantized tree through the JAX int8 model (its XLA
    formulation, or its Pallas kernel) and the port's, f32 on the CPU, on a
    42x42 input (10 tokens), where no rounding decision of the two flips."""
    qparams, model = tiny_q
    counted = None
    if jax_path == "pallas-interpret":
        counted = _Counted(J_qm.quant_dense_matmul)
        monkeypatch.setattr(J_quant, "_use_kernel", lambda kernel_q: True)
        monkeypatch.setattr(J_qm, "quant_dense_matmul", counted)
    x = np.random.default_rng(8).standard_normal((1, 42, 42, 3)).astype(np.float32)
    want = _jax_depth(qparams, x)
    if counted is not None:
        assert counted.calls == 16  # 4 layers × qkv, proj, fc1, fc2
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 42, 42)
    print(f"port vs JAX int8 ({jax_path}): max rel {_rel(got, want):.3e}")
    assert _rel(got, want) < MODEL_REL_TOL


def test_tiny_int8_model_drift_stays_below_int8_noise(tiny_q):
    """On 46 tokens (70x126) the port's and JAX's f32 LayerNorm, attention
    and GELU differ by ~1e-6, which moves an activation across a rounding
    boundary now and then; the changed int8 value then changes the next
    layer's rounding decisions too.  The two int8 models may so land on
    different quantisation noise, but their difference stays below the
    quantisation noise itself (int8 against float on the JAX side)."""
    qparams, model = tiny_q
    x = np.random.default_rng(8).standard_normal((1, 70, 126, 3)).astype(np.float32)
    want = _jax_depth(qparams, x)
    float_params = {"params": _seeded_params(JDepthAnything(**TINY_Q),
                                             jnp.zeros((1, 28, 42, 3), jnp.float32))["params"]}
    noise = _rel_l2(want, _jax_depth(float_params, x, quant=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    drift = _rel_l2(got, want)
    print(f"port vs JAX int8: rel L2 {drift:.5f}, max rel {_rel(got, want):.5f}; "
          f"JAX int8 vs float: rel L2 {noise:.5f}")
    assert drift < noise


def test_int8_model_tracks_float_model():
    """Depth-Anything-V2-Small from one build_bound seed, int8 against
    float: the JAX suite's correlation bound (its own draw stays within 0.1
    relative; the port's draw and ViT-L at 126x224 reach ~0.14)."""
    fmodel, _ = build_bound("Depth-Anything-V2-Small", device="cpu", seed=3)
    qmodel, _ = build_bound("Depth-Anything-V2-Small", device="cpu", seed=3, quant="int8")
    assert isinstance(qmodel.backbone.layer[0].mlp.fc2, T_quant.QuantLinear)
    assert qmodel.backbone.layer[0].mlp.fc2.weight_q.dtype == torch.int8
    fsd = fmodel.state_dict()
    for k, v in qmodel.state_dict().items():  # one float draw under both
        if k in fsd:
            assert torch.equal(v, fsd[k]), k
    x = torch.from_numpy(np.random.default_rng(2).random((1, 70, 70, 3)).astype(np.float32))
    with torch.no_grad():
        df = fmodel(x).numpy().ravel()
        dq = qmodel(x).numpy().ravel()
    corr = float(np.corrcoef(df, dq)[0, 1])
    print(f"DA-V2-Small int8 vs float: corr {corr:.5f}, max rel {_rel(dq, df):.4f}")
    assert corr > 0.99, corr
    assert _rel(dq, df) < 0.2


def test_build_bound_int8_keeps_f32_scales_in_bf16():
    model, _ = build_bound("Depth-Anything-V2-Small", device="cpu", dtype=torch.bfloat16,
                           quant="int8")
    qkv = model.backbone.layer[0].attention.qkv
    assert qkv.weight_q.dtype == torch.int8
    assert qkv.scale.dtype == torch.float32 and qkv.bias.dtype == torch.float32
    assert model.backbone.layer[0].norm1.weight.dtype == torch.bfloat16
    assert next(model.parameters()).device == torch.device("cpu")


def test_build_bound_refuses_unknown_quant():
    with pytest.raises(ValueError, match="int4"):
        build_bound("Depth-Anything-V2-Small", device="cpu", quant="int4")


def _k4_args(M=8, K=64, F=16, dtype=torch.bfloat16):
    x = torch.zeros(M, K, dtype=dtype)
    return x, torch.zeros(F, K, dtype=torch.int8), torch.ones(F), torch.zeros(F), None


@pytest.mark.parametrize("make", [
    lambda: _k4_args(M=1, K=32, F=1),                             # one row, one feature
    lambda: _k4_args(M=778, K=4096, F=1024, dtype=torch.float32),
    lambda: (torch.zeros(130, 1088, dtype=torch.bfloat16)[:, 32:32 + 1024],) + _k4_args(
        K=1024, F=200)[1:],                                       # a row stride wider than K
    lambda: _k4_args(M=65, K=96, F=200)[:4] + (torch.ones(65),),  # row_scale
], ids=["one-row", "fc2-f32", "strided-rows", "row-scale"])
def test_kernel_input_checks_accept(make):
    x2, wq, scale, bias, rs = make()
    K_qm.check_inputs(x2, wq, scale, bias, rs, x2.dtype)
    K_qm.check_inputs(x2, wq, scale, None, rs, torch.int32)


@pytest.mark.parametrize("make,match", [
    (lambda: _k4_args(K=48), "multiple of 32"),
    (lambda: _k4_args(dtype=torch.float16), "bf16 or f32"),
    (lambda: (torch.zeros(8, 66, dtype=torch.bfloat16)[:, 2:],) + _k4_args()[1:], "aligned"),
    (lambda: _k4_args()[:1] + (torch.zeros(64, 16, dtype=torch.int8).t(),) + _k4_args()[2:],
     "contiguous"),
    (lambda: _k4_args()[:1] + (torch.zeros(16, 32, dtype=torch.int8),) + _k4_args()[2:],
     r"weight_q \[F, 64\]"),
    (lambda: _k4_args()[:3] + (torch.zeros(15),) + (None,), "bias of 16"),
    (lambda: _k4_args()[:4] + (torch.ones(8, dtype=torch.float64),), "row_scale of 8"),
], ids=["ragged-K", "fp16", "misaligned", "weight-transposed", "weight-width", "bias-size",
        "row-scale-dtype"])
def test_kernel_input_checks_raise(make, match):
    with pytest.raises(ValueError, match=match):
        K_qm.check_inputs(*make(), torch.bfloat16)


def test_kernel_input_checks_refuse_other_output_types():
    with pytest.raises(ValueError, match="f32, bf16 or int32"):
        K_qm.check_inputs(*_k4_args(), torch.float16)
