"""The port's attention against the JAX package's, on the CPU in f32.

On the CPU the port's attention runs its plain version, `attention_ref`;
the CUDA kernel it stands beside is checked on the card (test_torch_cuda.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

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
    (lambda: (torch.zeros(1, 8, 2, 64),) * 3, "bf16"),
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
