"""The port's horizontal-resample plain version (kernel K3's) against the JAX
package's warp kernel and its jnp reference, on the CPU in f32.

The JAX kernel runs in Pallas interpret mode, as the JAX package's own
kernel tests run it.  Both sides get the same image and positions, made with
numpy from a seed.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from desktop2stereo_tpu.ops.pallas.warp import horizontal_sample as j_kernel
from desktop2stereo_tpu.ops.pallas.warp import horizontal_sample_ref as j_ref
from desktop2stereo_tpu_torch.ops.kernels import warp as K
from torch_threads import one_torch_thread  # noqa: F401

# the JAX suite's bound for this kernel, on its [0, 1) images
# (tests/test_pallas_kernels.py): ~80 ulp of a value near 1
TOL = 1e-5


def _inputs(H, W, C, seed, reach=90.0):
    rng = np.random.default_rng(seed)
    img = rng.random((H, W, C), dtype=np.float32)
    base = np.tile(np.arange(W, dtype=np.float32), (H, 1))
    px = np.clip(base + rng.uniform(-reach, reach, (H, W)), 0, W - 1).astype(np.float32)
    px[:, -1] = W - 1  # the last column, where the JAX kernel reads its pad
    return img, px


@pytest.mark.parametrize("H,W,C", [(64, 300, 3), (50, 200, 1), (7, 1, 3)])
def test_plain_version_matches_jax(H, W, C):
    img, px = _inputs(H, W, C, seed=H * W + C)
    got = K.horizontal_sample(torch.from_numpy(img), torch.from_numpy(px)).numpy()
    want_kernel = np.asarray(j_kernel(jnp.asarray(img), jnp.asarray(px),
                                      max_disp=128, interpret=True))
    want_ref = np.asarray(j_ref(jnp.asarray(img), jnp.asarray(px)))
    assert got.shape == (H, W, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    img, px = _inputs(8, 40, 3, seed=1)
    before = K.KERNEL.launches
    got = K.horizontal_sample(torch.from_numpy(img), torch.from_numpy(px))
    assert K.KERNEL.launches == before
    assert torch.equal(got, K.horizontal_sample_ref(torch.from_numpy(img), torch.from_numpy(px)))


@pytest.mark.parametrize("img,px,match", [
    (torch.zeros(8, 16), torch.zeros(8, 16), r"\[H,W,C\]"),
    (torch.zeros(8, 16, 3), torch.zeros(8, 15), r"\[H,W,C\]"),
    (torch.zeros(8, 16, 3, dtype=torch.float64), torch.zeros(8, 16), "f32"),
    (torch.zeros(8, 3, 16).transpose(1, 2), torch.zeros(8, 16), "contiguous"),
])
def test_input_checks_raise(img, px, match):
    with pytest.raises(ValueError, match=match):
        K.horizontal_sample(img, px)
