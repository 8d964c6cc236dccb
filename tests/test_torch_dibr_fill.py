"""The port's single-eye DIBR (kernel K5's plain version, and `dibr_render`
around it) against the JAX package, on the CPU in f32.

The JAX kernel `dibr_warp_fill_blend` runs in Pallas interpret mode on its
edge- and tile-padded input, as the JAX package's own kernel tests run it;
the port takes the true frame (clamp-to-edge reads equal the padded reads).
50×200 is a shape the JAX kernel pads in both axes.  `dibr_render` is held
against the JAX `dibr_render` on its CPU jnp path, at roll 0 (where the port
runs K5's plain version) and rolled (the 2-D plain path on both sides).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from desktop2stereo_tpu.ops import stereo as J_stereo
from desktop2stereo_tpu.ops.pallas.dibr import dibr_warp_fill_blend as j_kernel
from desktop2stereo_tpu_torch.ops import stereo as T_stereo
from desktop2stereo_tpu_torch.ops.kernels import dibr_fill as K
from desktop2stereo_tpu_torch.ops.kernels.dibr import PIX, quantize_u8, tile_geometry
from test_torch_dibr import _edgy_frame, saturated, unneeded, walk_sweep, warp_of
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


def _emulate_fill(rgb, depth, conf, px, *, sweep_sign, search_radius, seg_target,
                  depth_tolerance=0.012):
    """One eye as the K5 kernel computes it: per block, the staged tile; per
    thread-group, PIX pixels whose sweeps walk the tile (the depth-weighted
    one in the direction of the sign, then the opposite one)."""
    H, W, _ = rgb.shape
    R = search_radius
    g = tile_geometry(W, R, seg_target)
    out = torch.full_like(rgb, float("nan"))
    rows = torch.arange(H)[:, None]
    for bx in range(g.grid_x):
        s0 = bx * g.seg
        cols = torch.arange(s0 - g.halo, s0 + g.seg + g.halo).clamp(0, W - 1)
        d_t, rgb_t = depth[:, cols], rgb[:, cols]
        i = torch.arange(math.ceil((min(s0 + g.seg, W) - s0) / PIX))
        l0 = PIX * i + g.halo
        d = lambda off: d_t[:, l0 + off]  # noqa: E731
        cdi = [-(d(j) * 0.7 + ((d(j + 1) * 0.5 + d(j + 2) * 0.5)
                               + (d(j - 1) * 0.5 + d(j - 2) * 0.5)) * 0.15) for j in range(PIX)]
        gate = lambda j: cdi[j] + depth_tolerance  # noqa: E731
        warp = warp_of(i, g.threads)
        fwd_c, fwd_w = walk_sweep(
            1.0 - d_t, rgb_t, l0, R, sweep_sign, gate,
            lambda j, t, v: math.exp(-t * 0.15) * (1.0 + (v - cdi[j]) * 10.0), warp, saturated)
        bwd_c, bwd_w = walk_sweep(1.0 - d_t, rgb_t, l0, R, -sweep_sign, gate,
                                  lambda j, t, v: torch.full_like(v, math.exp(-t * 0.2)),
                                  warp, unneeded(fwd_w))
        for j in range(PIX):
            x = s0 + PIX * i + j
            xc = x.clamp(max=W - 1)
            need_bwd = fwd_w[j] < 2.0
            best_c = fwd_c[j] + torch.where(need_bwd[..., None], bwd_c[j], 0.0)
            best_w = fwd_w[j] + torch.where(need_bwd, bwd_w[j], 0.0)
            vert_c = (best_c * (1.0 / best_w.clamp_min(1e-12))[..., None]) * 0.5
            vert_w = torch.full_like(best_w, 0.5)
            for off in (-K.VSHIFT, K.VSHIFT):
                yy = (rows + off).clamp(0, H - 1)
                w = torch.where((1.0 - depth[yy, xc]) > cdi[j] + depth_tolerance * 0.5,
                                0.25, 0.0)
                vert_c = vert_c + rgb[yy, xc] * w[..., None]
                vert_w = vert_w + w
            filled = torch.where((best_w > 0.01)[..., None], vert_c * (1.0 / vert_w)[..., None],
                                 rgb_t[:, l0 + j])
            pp = px[:, xc]
            x0 = torch.floor(pp)
            frac = (pp - x0)[..., None]
            i0 = x0.long().clamp(0, W - 1)
            color = rgb[rows, i0] * (1.0 - frac) + rgb[rows, (i0 + 1).clamp(max=W - 1)] * frac
            keep = x < W
            blend = color + conf[:, xc][..., None] * (filled - color)
            out[:, x[keep]] = blend[:, keep]
    return out


@pytest.mark.parametrize("H,W,radius,sign,seg_target", [
    (5, 61, 12, 1.0, 512), (4, 64, 12, -1.0, 8), (3, 70, 32, 1.0, 0),
    (2, 9, 0, -1.0, 512), (6, 33, 1, 1.0, 512), (5, 40, 5, -1.0, 16), (3, 1100, 12, -1.0, 512)])
def test_column_walk_matches_plain_version_bit_for_bit(H, W, radius, sign, seg_target):
    rgb, dep = _edgy_frame(H, W, seed=W + radius)
    rgb = rgb.permute(1, 2, 0).contiguous()
    rng = np.random.default_rng(H)
    conf = torch.from_numpy(rng.random((H, W), dtype=np.float32))
    base = np.arange(W, dtype=np.float32)[None]
    px = torch.from_numpy(np.clip(base + rng.uniform(-20, 20, (H, W)), 0, W - 1)
                          .astype(np.float32))
    kw = dict(sweep_sign=sign, search_radius=radius)
    got = _emulate_fill(rgb, dep, conf, px, seg_target=seg_target, **kw)
    assert torch.equal(got, K.dibr_warp_fill_blend_ref(rgb, dep, conf, px, **kw))
