"""The port's both-eyes DIBR plain version against the JAX pair kernel.

The JAX side is `dibr_render_pair_planar` in Pallas interpret mode, on its
edge-padded planar input, as the JAX package's own kernel tests run it; the
port takes the true eye-size frame (clamp-to-edge reads equal the padded
reads).  50×200 is a shape the JAX code pads in both axes.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from desktop2stereo_tpu.ops.pallas.dibr import dibr_render_pair_planar, pair_tiling
from desktop2stereo_tpu_torch.ops.kernels import dibr as K
from torch_threads import one_torch_thread  # noqa: F401

# (H, W, depth_strength, convergence, feather)
CASES = [
    (96, 256, 2.0, 0.01, 0.0),
    (96, 256, 1.0, -0.1, 0.08),
    (50, 200, 2.0, 0.01, 0.0),
    (50, 200, 3.5, 0.05, 0.02),
]


def _inputs(H, W, seed):
    rng = np.random.default_rng(seed)
    rgb = (rng.random((3, H, W)) * 255.0).astype(np.float32)
    dep = rng.random((H, W)).astype(np.float32)
    return rgb, dep


@functools.lru_cache(maxsize=None)  # both arrangements share one JAX run
def _jax_case(H, W, seed, out_mode, strength, conv, feather):
    rgb, dep = _inputs(H, W, seed)
    return _jax_pair(rgb, dep, out_mode, strength, conv, feather)


def _jax_pair(rgb, dep, out_mode, strength, conv, feather):
    _, H, W = rgb.shape
    hp, wp, _ = pair_tiling(H, W)
    rgbp = jnp.pad(jnp.asarray(rgb), ((0, 0), (0, hp - H), (0, wp - W)), mode="edge")
    depp = jnp.pad(jnp.asarray(dep), ((0, hp - H), (0, wp - W)), mode="edge")[None]
    left, right = dibr_render_pair_planar(
        rgbp, depp, W, ipd=0.064, depth_strength=strength, convergence=conv,
        feather=feather, height=H, out_mode=out_mode, interpret=True)
    return np.asarray(left)[:, :H, :W], np.asarray(right)[:, :H, :W]


@pytest.mark.parametrize("H,W,strength,conv,feather", CASES)
def test_eyes_f32_match_jax_kernel(H, W, strength, conv, feather):
    rgb, dep = _inputs(H, W, seed=H + W)
    want_l, want_r = _jax_pair(rgb, dep, "eyes", strength, conv, feather)
    got_l, got_r = K.dibr_pair_eyes_ref(
        torch.from_numpy(rgb), torch.from_numpy(dep), ipd=0.064,
        depth_strength=strength, convergence=conv, feather=feather)
    # f32 on 0..255 values; the warp turns a one-ulp change of its position
    # into up to ~4e-3, which the matched rounding order keeps out
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_r.numpy(), want_r, atol=1e-3, rtol=0)


@pytest.mark.parametrize("arrangement", ["sbs", "tab"])
@pytest.mark.parametrize("H,W,strength,conv,feather", CASES[::2] + CASES[3:])
def test_half_u8_matches_jax_eyes_u8(H, W, strength, conv, feather, arrangement):
    """The finished frame ≡ JAX eyes_u8 + the program's concat/transpose."""
    rgb, dep = _inputs(H, W, seed=H * W)
    lq, rq = _jax_case(H, W, H * W, "eyes_u8", strength, conv, feather)
    want = np.concatenate([lq, rq], axis=2 if arrangement == "sbs" else 1).transpose(1, 2, 0)
    got = K.dibr_pair_half(torch.from_numpy(rgb), torch.from_numpy(dep), ipd=0.064,
                           depth_strength=strength, convergence=conv,
                           feather=feather, arrangement=arrangement).numpy()
    assert got.shape == ((H, 2 * W, 3) if arrangement == "sbs" else (2 * H, W, 3))
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def test_inpaint_taps_read_raw_depth():
    """Only the centre depth is smoothed; the sweep and vertical taps read
    raw depth.  A one-pixel near spike inside a far run, on a ramp image,
    makes the raw/smoothed distinction visible in the fill; the plain
    version must still match the JAX kernel there."""
    H, W = 8, 64
    rgb = torch.arange(W, dtype=torch.float32).expand(3, H, W).contiguous() * 3.0
    dep = torch.full((H, W), 0.2)
    dep[:, 30:] = 0.9
    dep[:, 28] = 0.95  # a near spike inside the far region
    left, _ = K.dibr_pair_eyes_ref(rgb, dep, ipd=0.064, depth_strength=2.0,
                                   convergence=0.0)
    jl, _ = _jax_pair(rgb.numpy(), dep.numpy(), "eyes", 2.0, 0.0, 0.0)
    np.testing.assert_allclose(left.numpy(), jl, atol=1e-3, rtol=0)


@pytest.mark.parametrize("rgb,dep,arr,match", [
    ((3, 8, 16), (8, 16), "side", "arrangement"),
    ((4, 8, 16), (8, 16), "sbs", r"\[3,eh,ew\]"),
    ((3, 8, 16), (8, 15), "sbs", r"\[3,eh,ew\]"),
])
def test_kernel_input_checks_raise(rgb, dep, arr, match):
    with pytest.raises(ValueError, match=match):
        K.check_inputs(torch.zeros(rgb), torch.zeros(dep), arr)


def test_kernel_input_checks_dtype_and_layout():
    with pytest.raises(ValueError, match="f32"):
        K.check_inputs(torch.zeros(3, 8, 16, dtype=torch.float64), torch.zeros(8, 16), "sbs")
    with pytest.raises(ValueError, match="contiguous"):
        K.check_inputs(torch.zeros(3, 16, 8).transpose(1, 2), torch.zeros(8, 16), "sbs")
