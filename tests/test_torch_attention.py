"""The port's attention against the JAX package's, on the CPU in f32.

On the CPU the port's attention runs its plain versions, `attention_ref`
and `attention_relpos_ref` (BEiT's relative-position bias from its table);
the CUDA kernel they stand beside is checked on the card (test_torch_cuda.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import desktop2stereo_tpu.models.beit as J_beit
from desktop2stereo_tpu.ops.attention import xla_attention
from desktop2stereo_tpu.ops.pallas.flash_attention import flash_attention
from desktop2stereo_tpu_torch.ops.attention import attention_ref, multi_head_attention
from desktop2stereo_tpu_torch.ops.kernels import attention as K
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5  # f32 softmax attention, summation-order rounding


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 130, 4, 64), (1, 200, 2, 64)])
def test_attention_ref_matches_xla_and_pallas(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    got = attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(xla_attention(jq, jk, jv)), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(flash_attention(jq, jk, jv, interpret=True)),
                               atol=TOL, rtol=0)


def test_cpu_dispatch_takes_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv((1, 37, 3, 32), seed=1))
    launches = K.KERNEL.launches
    assert torch.equal(multi_head_attention(q, k, v), attention_ref(q, k, v))
    assert K.KERNEL.launches == launches


def test_strided_qkv_views_match_contiguous():
    """The model hands attention strided views of its fused qkv projection."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 50, 3 * 128)).astype(np.float32))
    q, k, v = (t.unflatten(-1, (2, 64)) for t in qkv.split(128, dim=-1))
    assert q.stride() == (50 * 384, 384, 64, 1)
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(multi_head_attention(q, k, v), want, atol=0, rtol=0)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,match", [
    (lambda: (_bf16((1, 8, 2, 32)),) * 3, "head dim 64"),
    (lambda: (_bf16((1, 8, 2, 64)), _bf16((1, 9, 2, 64)), _bf16((1, 8, 2, 64))), "equal"),
    (lambda: (torch.zeros(1, 8, 2, 64, dtype=torch.float16),) * 3, "bf16 or f32"),
    (lambda: (_bf16((1, 8, 64, 2)).transpose(-1, -2),) * 3, "contiguous head dim"),
    (lambda: (_bf16((1, 8, 2, 66))[..., :64],) * 3, "aligned"),
    (lambda: (_bf16((1, 1, 2, 64)).expand(1, 8, 2, 64),) * 3, "zero stride"),
])
def test_kernel_input_checks_raise(case, match):
    with pytest.raises(ValueError, match=match):
        K.check_inputs(*case())


def test_kernel_input_checks_accept_qkv_views():
    qkv = _bf16((1, 778, 3 * 1024))
    K.check_inputs(*(t.unflatten(-1, (16, 64)) for t in qkv.split(1024, dim=-1)))


# ---- f32 q/k/v: the kernel's SIMT body (`--fp32`, the converter's gate) ------------------

@pytest.mark.parametrize("mode", ["none", "bf16 bias", "f32 bias", "bf16 table", "f32 table"])
def test_kernel_input_checks_accept_f32_qkv_with_each_bias_mode(mode):
    """f32 q/k/v as the encoder's qkv views, with no bias, a dense [H, N, N]
    bias or BEiT-L @512's 18x32 table, each in bf16 or f32."""
    gh, gw = 18, 32
    n = gh * gw + 1
    qkv = torch.zeros(1, n, 3 * 1024)
    q, k, v = (t.unflatten(-1, (16, 64)) for t in qkv.split(1024, dim=-1))
    dtype = torch.float32 if mode.startswith("f32") else torch.bfloat16
    if mode == "none":
        K.check_inputs(q, k, v)
    elif mode.endswith("bias"):
        K.check_inputs(q, k, v, torch.zeros(16, n, n, dtype=dtype))
    else:
        K.check_inputs(q, k, v, rel_pos=(torch.zeros(16, K.relative_position_count(gh, gw),
                                                      dtype=dtype), gh, gw))


@pytest.mark.parametrize("case,match", [
    (lambda: (torch.zeros(1, 8, 2, 64), _bf16((1, 8, 2, 64)), torch.zeros(1, 8, 2, 64)),
     "one dtype"),
    (lambda: (torch.zeros(1, 8, 2, 64, dtype=torch.float64),) * 3, "bf16 or f32"),
    (lambda: (torch.zeros(1, 8, 2, 66)[..., :64],) * 3, "aligned"),
    (lambda: (torch.zeros(1, 8, 64, 2).transpose(-1, -2),) * 3, "contiguous head dim"),
    (lambda: (torch.zeros(1, 8, 2, 68)[..., 1:65],) * 3, "aligned"),
], ids=["mixed", "f64", "row-stride", "head-dim", "offset"])
def test_kernel_input_checks_refuse_bad_f32_inputs(case, match):
    with pytest.raises(ValueError, match=match):
        K.check_inputs(*case())


def test_kernel_input_checks_accept_an_f32_zero_stride():
    """The f32 body reads rows as float4 through plain pointers: no tensor
    map, so a broadcast (zero-stride) q/k/v is fine, where bf16 refuses it."""
    t = torch.zeros(1, 1, 2, 64).expand(1, 8, 2, 64)
    K.check_inputs(t, t, t)
    with pytest.raises(ValueError, match="zero stride"):
        K.check_inputs(*(_bf16((1, 1, 2, 64)).expand(1, 8, 2, 64),) * 3)


def test_f32_table_shared_memory_at_beit_large():
    """The f32 body's table entry at BEiT-L @512: the 64-row Q tile and two
    stages of a 64-key K tile (rows padded to 68 floats) and V tile, two
    ints for each of the 64 query rows, the 8.8 KB f32 row and 10 key tiles
    of 64 offsets; two blocks an SM's 228 KB."""
    smem = K.relpos_smem_bytes(577, 2208, f32=True)
    assert smem == (4 * (64 * 68 + 2 * (64 * 68 + 64 * 64)) + 2 * 64 * 4 + 2208 * 4
                    + 10 * 64 * 4) == 96896
    assert 2 * (smem + 1024) <= 233472


@pytest.mark.parametrize("bias", [None, "dense", "table"])
def test_f32_cpu_dispatch_takes_the_plain_version(bias):
    """f32 CPU tensors take the plain versions exactly, launching nothing."""
    gh, gw = 3, 4
    q, k, v = map(torch.from_numpy, _qkv((2, gh * gw + 1, 2, 64), seed=7))
    table = torch.from_numpy(_table(2, gh, gw, seed=8))
    launches = K.KERNEL.launches
    if bias == "table":
        got = multi_head_attention(q, k, v, rel_pos=(table, gh, gw))
        want = K.attention_relpos_ref(q, k, v, table, gh, gw)
    else:
        dense = K.expand_rel_pos(table, gh, gw) if bias else None
        got = multi_head_attention(q, k, v, bias=dense)
        want = attention_ref(q, k, v, dense)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert K.KERNEL.launches == launches


# N either side of the f32 body's 64-row query and 64-key tiles, each a
# gh x gw + 1 token grid for the table
F32_TILE_EDGES = {63: (2, 31), 64: (7, 9), 65: (8, 8), 129: (8, 16)}


@pytest.mark.parametrize("bias", [None, "dense", "table"])
@pytest.mark.parametrize("n", sorted(F32_TILE_EDGES))
def test_f32_plain_version_at_the_tile_edges_matches_jax(n, bias):
    """At N either side of the f32 body's tiles the f32 plain version, as an
    f32 CPU call takes it (launching nothing), agrees with the JAX
    `flash_attention` in interpret mode, or with `xla_attention` on JAX's
    gather of the same bias."""
    gh, gw = F32_TILE_EDGES[n]
    q, k, v = _qkv((2, n, 2, 64), seed=n)
    table = _table(2, gh, gw, seed=n + 1)
    tq, tk, tv, tt = map(torch.from_numpy, (q, k, v, table))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    launches = K.KERNEL.launches
    if bias is None:
        got = multi_head_attention(tq, tk, tv)
        want = flash_attention(jq, jk, jv, interpret=True)
    elif bias == "dense":
        got = multi_head_attention(tq, tk, tv, bias=K.expand_rel_pos(tt, gh, gw))
        want = xla_attention(jq, jk, jv, bias=_jax_dense_bias(table, gh, gw))
    else:
        got = multi_head_attention(tq, tk, tv, rel_pos=(tt, gh, gw))
        want = xla_attention(jq, jk, jv, bias=_jax_dense_bias(table, gh, gw))
    assert K.KERNEL.launches == launches and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("make", [
    lambda: _bf16((3, 1, 2, 64)),                        # one token
    lambda: _bf16((2, 4, 3, 64)).transpose(1, 2)[:, :, :4].transpose(1, 2),  # a slice
    lambda: _bf16((2, 3, 9, 64)).transpose(1, 2),        # tokens nearer than heads
    lambda: _bf16((512,)).as_strided((4, 1, 2, 64), (128, 0, 64, 1)),  # zero stride, size 1
], ids=["one-token", "sliced", "heads-major", "size-1-zero-stride"])
def test_kernel_input_checks_accept_other_layouts(make):
    t = make()
    K.check_inputs(t, t, t)


# ---- the additive bias (BEiT's relative-position bias) -----------------------------------

@pytest.mark.parametrize("shape", [(2, 130, 4, 64), (1, 37, 3, 32), (1, 1, 2, 64)])
def test_biased_attention_ref_matches_xla(shape):
    """`bias` [H, N, N] added to the scaled logits, broadcast over the
    batch, as `xla_attention(..., bias)` adds it."""
    q, k, v = _qkv(shape, seed=sum(shape) + 1)
    _, N, H, _ = shape
    bias = 2.0 * np.random.default_rng(3).standard_normal((H, N, N)).astype(np.float32)
    got = attention_ref(*map(torch.from_numpy, (q, k, v, bias))).numpy()
    want = np.asarray(xla_attention(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    unbiased = attention_ref(*map(torch.from_numpy, (q, k, v))).numpy()
    assert N == 1 or np.abs(got - unbiased).max() > 1e-2  # the bias moves the output


def test_cpu_dispatch_takes_the_plain_version_with_a_bias():
    q, k, v = map(torch.from_numpy, _qkv((2, 20, 3, 64), seed=4))
    bias = torch.randn(3, 20, 20, dtype=torch.bfloat16)
    launches = K.KERNEL.launches
    assert torch.equal(multi_head_attention(q, k, v, bias=bias), attention_ref(q, k, v, bias))
    assert K.KERNEL.launches == launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_input_checks_accept_a_bias(dtype):
    qkv = _bf16((1, 577, 3 * 1024))
    q, k, v = (t.unflatten(-1, (16, 64)) for t in qkv.split(1024, dim=-1))
    K.check_inputs(q, k, v, torch.zeros(16, 577, 577, dtype=dtype))


@pytest.mark.parametrize("bias,match", [
    (lambda: torch.zeros(2, 8, 9, dtype=torch.bfloat16), r"\[H, N, N\]"),
    (lambda: torch.zeros(1, 8, 8, dtype=torch.bfloat16), r"\[H, N, N\]"),
    (lambda: torch.zeros(1, 2, 8, 8, dtype=torch.bfloat16), r"\[H, N, N\]"),
    (lambda: torch.zeros(2, 8, 8, dtype=torch.float16), "bf16 or f32"),
    (lambda: torch.zeros(2, 8, 8, dtype=torch.float64), "bf16 or f32"),
    (lambda: torch.zeros(2, 8, 8, dtype=torch.bfloat16).transpose(1, 2), "contiguous"),
    (lambda: torch.zeros(2 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 8), "aligned"),
], ids=["ragged", "heads", "rank", "f16", "f64", "transposed", "misaligned"])
def test_kernel_input_checks_refuse_a_bad_bias(bias, match):
    q = _bf16((1, 8, 2, 64))
    with pytest.raises(ValueError, match=match):
        K.check_inputs(q, q, q, bias())


# ---- the table entry (BEiT's relative-position bias gathered from its table) ------------

RELPOS_GRIDS = [(1, 1), (1, 7), (5, 1), (3, 6), (18, 32), (24, 32), (32, 32)]


def _kernel_index(gh, gw):
    """The index map as the table entry computes it (csrc/attention.cu):
    for patch t-1 at (y, x) = ((t-1) // gw, (t-1) % gw), a_i = (y_i + gh -
    1)(2gw - 1) + x_i + gw - 1 and b_j = y_j (2gw - 1) + x_j (b_0 = 0);
    idx = a_i - m_i·b_j with a = R-3 and m = 0 on the cls row; key 0's cls
    entry (R-1 on the cls row, R-2 elsewhere) put in by a select."""
    R = K.relative_position_count(gh, gw)
    p = np.arange(gh * gw)
    y, x = p // gw, p % gw
    a = np.concatenate([[R - 3], (y + gh - 1) * (2 * gw - 1) + x + gw - 1])
    b = np.concatenate([[0], y * (2 * gw - 1) + x])
    m = np.ones_like(a)
    m[0] = 0
    index = a[:, None] - m[:, None] * b[None, :]
    index[:, 0] = R - 2
    index[0, 0] = R - 1
    return index


@pytest.mark.parametrize("grid", RELPOS_GRIDS, ids=[f"{h}x{w}" for h, w in RELPOS_GRIDS])
def test_closed_form_index_equals_the_index_map(grid):
    """a_i - b_j and the three cls entries equal HF's index map, the port's
    copy and the JAX package's, entry for entry."""
    gh, gw = grid
    n = gh * gw + 1
    got = _kernel_index(gh, gw)
    assert got.shape == (n, n)
    np.testing.assert_array_equal(got.reshape(-1), K._relative_position_index(gh, gw))
    np.testing.assert_array_equal(got.reshape(-1), J_beit._relative_position_index(gh, gw))
    assert got.min() >= 0 and got.max() == K.relative_position_count(gh, gw) - 1


def _table(H, gh, gw, seed):
    return 2.0 * np.random.default_rng(seed).standard_normal(
        (H, K.relative_position_count(gh, gw))).astype(np.float32)


def _jax_dense_bias(table, gh, gw):
    """JAX's gather of an [H, R] table through JAX's index map, as
    `build_rel_pos_bias` does on the pretraining window."""
    n = gh * gw + 1
    bias = jnp.take(jnp.asarray(table.T), jnp.asarray(J_beit._relative_position_index(gh, gw)),
                    axis=0)
    return bias.reshape(n, n, table.shape[0]).transpose(2, 0, 1)


@pytest.mark.parametrize("grid,B,H", [((1, 1), 2, 2), ((3, 6), 2, 3), ((5, 1), 1, 4),
                                      ((4, 4), 1, 2), ((2, 7), 2, 2)],
                         ids=["1x1", "3x6", "5x1", "4x4", "2x7"])
def test_attention_relpos_ref_matches_the_dense_bias_and_xla(grid, B, H):
    """The plain version equals `attention_ref` on the dense expansion bit
    for bit, and JAX's `xla_attention` on JAX's gather of the same table."""
    gh, gw = grid
    n = gh * gw + 1
    q, k, v = _qkv((B, n, H, 64), seed=gh * 10 + gw)
    table = _table(H, gh, gw, seed=gh + gw)
    tq, tk, tv, tt = map(torch.from_numpy, (q, k, v, table))
    got = K.attention_relpos_ref(tq, tk, tv, tt, gh, gw)
    dense = K.expand_rel_pos(tt, gh, gw)
    assert dense.shape == (H, n, n) and dense.is_contiguous()
    assert torch.equal(got, attention_ref(tq, tk, tv, dense))
    jbias = _jax_dense_bias(table, gh, gw)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jbias))
    want = np.asarray(xla_attention(*map(jnp.asarray, (q, k, v)), bias=jbias))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    if gh == gw:  # on the pretraining window JAX's own builder takes the [R, H] table
        jb = J_beit.build_rel_pos_bias(jnp.asarray(table.T), gh, gw, gh, H)
        np.testing.assert_array_equal(dense.numpy(), np.asarray(jb))
    assert np.abs(got.numpy() - attention_ref(tq, tk, tv).numpy()).max() > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_takes_the_plain_version_with_a_table(dtype):
    gh, gw = 3, 4
    q, k, v = (t.to(dtype) for t in map(torch.from_numpy, _qkv((2, 13, 2, 64), seed=5)))
    table = torch.from_numpy(_table(2, gh, gw, seed=6)).to(dtype)
    launches = K.KERNEL.launches
    got = multi_head_attention(q, k, v, rel_pos=(table, gh, gw))
    assert torch.equal(got, K.attention_relpos_ref(q, k, v, table, gh, gw))
    assert torch.equal(got, K.attention_relpos(q, k, v, table, gh, gw))
    assert K.KERNEL.launches == launches and got.dtype == dtype


def test_table_entry_refuses_mixed_devices_and_a_bias_beside_it():
    q = torch.zeros(1, 5, 2, 64)
    table = torch.zeros(2, K.relative_position_count(2, 2), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        K.attention_relpos(q, q, q, table, 2, 2)
    with pytest.raises(ValueError, match="not both"):
        multi_head_attention(q, q, q, bias=torch.zeros(2, 5, 5),
                             rel_pos=(torch.zeros(2, K.relative_position_count(2, 2)), 2, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", [(18, 32), (24, 32), (32, 32), (1, 1)],
                         ids=["18x32", "24x32", "32x32", "1x1"])
def test_kernel_input_checks_accept_a_table(grid, dtype):
    gh, gw = grid
    qkv = _bf16((1, gh * gw + 1, 3 * 1024))
    q, k, v = (t.unflatten(-1, (16, 64)) for t in qkv.split(1024, dim=-1))
    table = torch.zeros(16, K.relative_position_count(gh, gw), dtype=dtype)
    K.check_inputs(q, k, v, rel_pos=(table, gh, gw))


def test_table_entry_shared_memory_at_beit_large():
    """BEiT-L @512's 18x32 grid: an 8.8 KB f32 row and 5 key tiles of
    offsets beside the dense entry's 73 KB, two blocks an SM's 228 KB."""
    smem = K.relpos_smem_bytes(577, 2208)
    assert smem == 1024 + 8192 + 65536 + 48 + 2208 * 4 + 5 * 128 * 4 == 86192
    assert 2 * (smem + 1024) <= 233472


_R = K.relative_position_count


@pytest.mark.parametrize("n,table,grid,match", [
    (20, lambda: torch.zeros(2, _R(3, 6), dtype=torch.bfloat16), (3, 6), "N = gh·gw"),
    (19, lambda: torch.zeros(2, _R(3, 6) - 1, dtype=torch.bfloat16), (3, 6), r"\[H, R\]"),
    (19, lambda: torch.zeros(3, _R(3, 6), dtype=torch.bfloat16), (3, 6), r"\[H, R\]"),
    (19, lambda: torch.zeros(_R(3, 6), 2, dtype=torch.bfloat16), (3, 6), r"\[H, R\]"),
    (19, lambda: torch.zeros(2, _R(3, 6), dtype=torch.float16), (3, 6), "bf16 or f32"),
    (19, lambda: torch.zeros(2, _R(3, 6), dtype=torch.float64), (3, 6), "bf16 or f32"),
    (19, lambda: torch.zeros(_R(3, 6), 2, dtype=torch.bfloat16).t(), (3, 6), "contiguous"),
    (19, lambda: torch.zeros(2 * _R(3, 6) + 1, dtype=torch.bfloat16)[1:].view(2, -1), (3, 6),
     "aligned"),
    (100 * 100 + 1, lambda: torch.zeros(2, _R(100, 100), dtype=torch.bfloat16), (100, 100),
     "shared memory"),
], ids=["wrong-n", "wrong-r", "heads", "untransposed", "f16", "f64", "non-contiguous",
        "misaligned", "oversize"])
def test_kernel_input_checks_refuse_a_bad_table(n, table, grid, match):
    q = _bf16((1, n, 2, 64))
    with pytest.raises(ValueError, match=match):
        K.check_inputs(q, q, q, rel_pos=(table(), *grid))
