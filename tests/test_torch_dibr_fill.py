"""The port's single-eye DIBR (kernel K5's plain version, and `dibr_render`
around it) against the JAX package, on the CPU in f32.

The JAX kernel `dibr_warp_fill_blend` runs in Pallas interpret mode on its
edge- and tile-padded input, as the JAX package's own kernel tests run it;
the port takes the true frame (clamp-to-edge reads equal the padded reads).
50×200 is a shape the JAX kernel pads in both axes.  `dibr_render` is held
against the JAX `dibr_render` on its CPU jnp path, at roll 0 (where the port
runs K5's plain version) and rolled (the 2-D plain path on both sides).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from desktop2stereo_tpu.ops import stereo as J_stereo
from desktop2stereo_tpu.ops.pallas.dibr import dibr_warp_fill_blend as j_kernel
from desktop2stereo_tpu_torch.ops import stereo as T_stereo
from desktop2stereo_tpu_torch.ops.kernels import dibr_fill as K
from desktop2stereo_tpu_torch.ops.kernels.dibr import quantize_u8
from torch_threads import one_torch_thread  # noqa: F401

KERNEL_TOL = 1e-3  # f32 on 0..255 values, the JAX suite's bound for this kernel


def _inputs(H, W, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.random((H, W, 3), dtype=np.float32) * 255.0
    dep = rng.random((H, W), dtype=np.float32)
    conf = rng.random((H, W), dtype=np.float32)
    base = np.tile(np.arange(W, dtype=np.float32), (H, 1))
    px = np.clip(base + rng.uniform(-40, 40, (H, W)), 0, W - 1).astype(np.float32)
    return rgb, dep, conf, px


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("H,W", [(64, 256), (50, 200)])
def test_plain_version_matches_jax_kernel(H, W, sign):
    arrays = _inputs(H, W, seed=H + W)
    want = np.asarray(j_kernel(*(jnp.asarray(a) for a in arrays), max_disp=64,
                               sweep_sign=sign, interpret=True))
    got = K.dibr_warp_fill_blend(*(torch.from_numpy(a) for a in arrays),
                                 sweep_sign=sign).numpy()
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=KERNEL_TOL, rtol=0)


def _u8_close(got, want):
    """≤1 LSB after u8, on ≤0.1% of the values: the warp position px is
    computed outside the kernel, and XLA contracts its multiply-adds where
    PyTorch rounds each op, so a one-ulp px moves a sample by up to ~0.06."""
    diff = np.abs(quantize_u8(torch.from_numpy(got)).numpy().astype(np.int32)
                  - quantize_u8(torch.from_numpy(np.array(want))).numpy().astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("eye,roll", [(-0.032, 0.0), (0.032, 0.0), (0.032, 0.3),
                                      (-0.032, np.pi)])
def test_dibr_render_matches_jax(eye, roll):
    rgb, dep, _, _ = _inputs(48, 96, seed=2)
    kw = dict(depth_strength=2.0, convergence=0.01, roll=roll)
    want = J_stereo.dibr_render(jnp.asarray(rgb), jnp.asarray(dep), eye, **kw)
    before = K.KERNEL.launches
    got = T_stereo.dibr_render(torch.from_numpy(rgb), torch.from_numpy(dep), eye, **kw)
    assert K.KERNEL.launches == before  # CPU tensors: the plain version
    assert got.shape == rgb.shape and got.dtype == torch.float32
    _u8_close(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version():
    arrays = [torch.from_numpy(a) for a in _inputs(16, 40, seed=3)]
    before = K.KERNEL.launches
    got = K.dibr_warp_fill_blend(*arrays, sweep_sign=-1.0)
    assert K.KERNEL.launches == before
    assert torch.equal(got, K.dibr_warp_fill_blend_ref(*arrays, sweep_sign=-1.0))


@pytest.mark.parametrize("change,kw,match", [
    (dict(rgb=torch.zeros(8, 16, 4)), {}, r"\[H,W,3\]"),
    (dict(px=torch.zeros(8, 15)), {}, r"\[H,W,3\]"),
    (dict(conf=torch.zeros(8, 16, dtype=torch.float64)), {}, "f32"),
    (dict(depth=torch.zeros(16, 8).t()), {}, "contiguous"),
    ({}, dict(search_radius=40), "search_radius"),
    ({}, dict(sweep_sign=0.5), "sweep_sign"),
])
def test_input_checks_raise(change, kw, match):
    args = dict(rgb=torch.zeros(8, 16, 3), depth=torch.zeros(8, 16),
                conf=torch.zeros(8, 16), px=torch.zeros(8, 16))
    args.update(change)
    with pytest.raises(ValueError, match=match):
        K.dibr_warp_fill_blend(args["rgb"], args["depth"], args["conf"], args["px"], **kw)
