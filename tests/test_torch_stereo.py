"""The port's `ops/stereo.py` and area resize against the JAX package's, on
the CPU in f32.

The JAX side takes its TPU dispatch: `stereo._on_tpu` returns True and the
Pallas kernels it reaches (K1 `dibr_render_pair`, K3 `horizontal_sample`,
K5 `dibr_warp_fill_blend`) run in interpret mode behind call counters.  The
JAX stereo code swallows a kernel failure and takes its jnp path, so every
test that needs a kernel asserts that its counter moved.  The port on the
CPU takes each kernel's plain version.
"""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import desktop2stereo_tpu.ops.pallas.dibr as J_dibr
import desktop2stereo_tpu.ops.pallas.warp as J_warp
from desktop2stereo_tpu.ops import stereo as J_stereo
from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES
from desktop2stereo_tpu_torch.ops import resize as T_resize
from desktop2stereo_tpu_torch.ops import stereo as T_stereo
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package's ops/__init__ re-exports the function `resize`, which
# shadows the submodule of the same name as an attribute
J_resize = importlib.import_module("desktop2stereo_tpu.ops.resize")

F32_TOL = 1e-3          # f32 on 0..255 values (the JAX suite's kernel bound)
F32_TOL_FEATHER = 2e-2  # with the feather's pow (tests/test_pallas_kernels.py)
ELEMENTWISE_TOL = 1e-5  # elementwise chains, rounded in the same order


class _Counted:
    """A JAX Pallas entry point run in interpret mode, counting the calls
    that returned."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, *args, **kw):
        out = self.fn(*args, **dict(kw, interpret=True))
        self.calls += 1
        return out


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setattr(J_stereo, "_on_tpu", lambda: True)
    counted = {}
    for mod, name in ((J_warp, "horizontal_sample"), (J_dibr, "dibr_render_pair"),
                      (J_dibr, "dibr_warp_fill_blend")):
        counted[name] = _Counted(getattr(mod, name))
        monkeypatch.setattr(mod, name, counted[name])
    return counted


def _scene(H=48, W=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((H, W, 3), dtype=np.float32) * 255.0,
            rng.random((H, W), dtype=np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ---- area resize -----------------------------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(7680, 3840), (322, 161), (10, 3), (7, 7), (5, 3)])
def test_area_tables_equal_jax(n_in, n_out):
    assert np.array_equal(T_resize.resize_weights(n_in, n_out, "area"),
                          J_resize.resize_weights(n_in, n_out, "area"))


@pytest.mark.parametrize("shape,size", [((12, 40, 3), (12, 20)), ((12, 41, 3), (6, 41)),
                                        ((9, 30, 3), (3, 10)), ((10, 30, 3), (4, 12))])
def test_area_resize_matches_table_and_jax(shape, size):
    """An integer factor takes the block mean; for the Half modes' factor 2
    it equals the table product exactly.  Other ratios take the table."""
    x = np.random.default_rng(1).random(shape, dtype=np.float32) * 255.0
    got = T_resize.resize(torch.from_numpy(x), size, mode="area")
    table = x
    for axis, n_out in ((0, size[0]), (1, size[1])):
        w = J_resize.resize_weights(table.shape[axis], n_out, "area").astype(np.float64)
        table = np.moveaxis(np.tensordot(w, np.moveaxis(table, axis, 0), axes=1), 0, axis)
    if all(n % m == 0 and n // m <= 2 for n, m in zip(shape, size)):
        np.testing.assert_array_equal(got.numpy(), table.astype(np.float32))
    _close(got, table, ELEMENTWISE_TOL * 255)
    _close(got, J_resize.resize(jnp.asarray(x), size, mode="area"), ELEMENTWISE_TOL * 255)


def test_resize_table_cached_in_inference_mode_serves_autograd_callers():
    x = torch.from_numpy(np.random.default_rng(7).random((13, 17, 3), dtype=np.float32))
    with torch.inference_mode():
        want = T_resize.resize(x, (9, 11), mode="bilinear")  # fills the table cache
    w = torch.ones(1, requires_grad=True)
    got = T_resize.resize(x * w, (9, 11), mode="bilinear")
    got.sum().backward()
    assert torch.allclose(got.detach(), want) and w.grad is not None


# ---- the fast compositor -----------------------------------------------------

@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("mode", ["Half-SBS", "Full-SBS", "Half-TAB", "Full-TAB"])
def test_make_sbs_matches_jax(jax_kernels, mode, fill):
    rgb, dep = _scene()
    want = J_stereo.make_sbs(jnp.asarray(rgb), jnp.asarray(dep), 0.064, 2.0, 0.01,
                             mode, fill_16_9=fill)
    assert jax_kernels["horizontal_sample"].calls == 2
    got = T_stereo.make_sbs(torch.from_numpy(rgb), torch.from_numpy(dep), 0.064, 2.0,
                            0.01, mode, fill_16_9=fill)
    _close(got, want, F32_TOL)


# ---- display composition ---------------------------------------------------

@pytest.mark.parametrize("mode", DISPLAY_MODES)
def test_compose_display_matches_jax(mode):
    rng = np.random.default_rng(2)
    left, right = (rng.random((9, 14, 3), dtype=np.float32) * 255.0 for _ in range(2))
    if mode == "Depth":  # a colormap of depth, not an arrangement of eyes
        for fn, arr in ((J_stereo.compose_display, jnp.asarray),
                        (T_stereo.compose_display, torch.from_numpy)):
            with pytest.raises(ValueError, match="unknown display mode"):
                fn(arr(left), arr(right), mode)
        return
    want = J_stereo.compose_display(jnp.asarray(left), jnp.asarray(right), mode)
    got = T_stereo.compose_display(torch.from_numpy(left), torch.from_numpy(right), mode)
    _close(got, want, 0.0)


@pytest.mark.parametrize("width", [T_stereo.FEATHER_WIDTH, 0.08])
def test_edge_feather_matches_jax(width):
    eye, _ = _scene(60, 104, seed=3)
    _close(T_stereo.edge_feather(torch.from_numpy(eye), width),
           J_stereo.edge_feather(jnp.asarray(eye), width), ELEMENTWISE_TOL)


def test_depth_colormap_matches_jax():
    _, dep = _scene(60, 104, seed=4)
    dep[0, :4] = (-0.5, 0.0, 1.0, 1.5)  # clipped ends
    _close(T_stereo.depth_colormap_spectral(torch.from_numpy(dep)),
           J_stereo.depth_colormap_spectral(jnp.asarray(dep)), ELEMENTWISE_TOL)


# ---- the whole stereo stage --------------------------------------------------

@pytest.mark.parametrize("feather", [False, True])
@pytest.mark.parametrize("quality,mode", [("high", "Full-SBS"), ("high", "Anaglyph"),
                                          ("high", "Depth"), ("fast", "Half-TAB"),
                                          ("fast", "Row-Interleaved")])
def test_stereo_compose_matches_jax(jax_kernels, quality, mode, feather):
    rgb, dep = _scene(seed=5)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01, display_mode=mode,
              quality=quality, feather=feather)
    want = J_stereo.stereo_compose(jnp.asarray(rgb), jnp.asarray(dep), **kw)
    if mode != "Depth":
        kernel = "dibr_render_pair" if quality == "high" else "horizontal_sample"
        assert jax_kernels[kernel].calls > 0, kernel
    got = T_stereo.stereo_compose(torch.from_numpy(rgb), torch.from_numpy(dep), **kw)
    # the fast compositor has no feather (as the reference's)
    _close(got, want, F32_TOL_FEATHER if feather and quality == "high" else F32_TOL)


def test_stereo_compose_fill_16_9_pads_each_eye(jax_kernels):
    rgb, dep = _scene(48, 48, seed=6)
    kw = dict(ipd=0.064, depth_strength=2.0, display_mode="Full-SBS", fill_16_9=True)
    want = J_stereo.stereo_compose(jnp.asarray(rgb), jnp.asarray(dep), **kw)
    assert jax_kernels["dibr_render_pair"].calls == 1
    got = T_stereo.stereo_compose(torch.from_numpy(rgb), torch.from_numpy(dep), **kw)
    assert got.shape == (48, 2 * 85, 3)
    _close(got, want, F32_TOL)


def test_unknown_display_mode_raises():
    rgb, dep = _scene(8, 16)
    with pytest.raises(ValueError, match="unknown display mode"):
        T_stereo.stereo_compose(torch.from_numpy(rgb), torch.from_numpy(dep),
                                display_mode="Checkerboard")


def test_reflect_coords_match_jax():
    px = np.linspace(-300.0, 300.0, 2001, dtype=np.float32)
    for size in (1, 2, 97):
        _close(T_stereo._reflect_coords(torch.from_numpy(px), size),
               J_stereo._reflect_coords(jnp.asarray(px), size), 0.0)

