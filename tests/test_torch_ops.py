"""The torch port's ops against the JAX package's, on the CPU in f32.

Inputs are made with numpy from a seed and fed to both sides.
"""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from desktop2stereo_tpu.ops import activations as J_act
from desktop2stereo_tpu.ops import depth_post as J_post
from desktop2stereo_tpu.ops import normalize as J_norm
from desktop2stereo_tpu_torch.ops import activations as T_act
from desktop2stereo_tpu_torch.ops import depth_post as T_post
from desktop2stereo_tpu_torch.ops import normalize as T_norm
from desktop2stereo_tpu_torch.ops import resize as T_resize
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package's ops/__init__ re-exports the function `resize`, which
# shadows the submodule of the same name as an attribute
J_resize = importlib.import_module("desktop2stereo_tpu.ops.resize")

TOL = 1e-5  # f32 matmul-resize / elementwise chains: summation-order rounding


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


@pytest.mark.parametrize("args", [
    (2160, 294, "bicubic", False, True),         # flagship model input, H
    (3840, 518, "bicubic", False, True),         # flagship model input, W
    (37, 21, "bicubic", False, False),           # DINOv2 pos-embed grid
    (37, 40, "bicubic", False, False),
    (294, 2160, "bilinear", False, False),       # depth to output size
    (21, 42, "bilinear", True, False),           # DPT fusion upsample
    (100, 7, "bilinear", False, True),
    (1080, 294, "bicubic", False, True),         # 1080p model input, H
    (42, 21, "bilinear", True, False),
])
def test_resize_weights_equal_jax(args):
    assert np.array_equal(T_resize.resize_weights(*args), J_resize.resize_weights(*args))


@pytest.mark.parametrize("shape,size,kw", [
    ((1, 90, 160, 3), (42, 70), dict(mode="bicubic", antialias=True)),
    ((1, 20, 30, 5), (40, 60), dict(mode="bilinear", align_corners=True)),
    ((1, 20, 30, 5), (33, 47), dict(mode="bilinear")),
    ((3, 40, 64, 1), (20, 32), dict(mode="bilinear", antialias=True)),
    ((37, 37, 8), (21, 37), dict(mode="bicubic")),
    ((2, 12, 40, 3), (30, 13), dict(mode="bicubic", antialias=True)),
    ((18, 24), (36, 48), dict(mode="bilinear")),
])
def test_resize_modes_match_jax(shape, size, kw):
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    _close(T_resize.resize(torch.from_numpy(x), size, **kw),
           J_resize.resize(jnp.asarray(x), size, **kw))


@pytest.mark.parametrize("halve_axis,full", [(1, (60, 96)), (0, (60, 96)), (1, (21, 42))])
def test_resize_halved_matches_jax(halve_axis, full):
    x = np.random.default_rng(1).random((21, 37, 1), dtype=np.float32)
    _close(T_resize.resize_halved(torch.from_numpy(x), full, halve_axis),
           J_resize.resize_halved(jnp.asarray(x), full, halve_axis))


def test_resize_halved_is_upsample_then_pair_mean():
    x = torch.from_numpy(np.random.default_rng(2).random((21, 37, 1), dtype=np.float32))
    full = T_resize.resize(x, (60, 96), mode="bilinear")
    want = (full[:, 0::2] + full[:, 1::2]) * 0.5
    _close(T_resize.resize_halved(x, (60, 96), 1), want)


@pytest.mark.parametrize("hw", [(2160, 3840), (180, 320), (1080, 1920), (577, 1001)])
@pytest.mark.parametrize("target", [518, 126, 384])
def test_sizes_match_jax(hw, target):
    assert T_resize.patch_aligned_size(*hw, target, 14) == J_resize.patch_aligned_size(*hw, target, 14)
    assert T_norm.process_frame_size(*hw, target) == J_norm.process_frame_size(*hw, target)


@pytest.mark.parametrize("family", ["imagenet", "half", "none"])
def test_normalize_matches_jax(family):
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (6, 10, 4), dtype=np.uint8)
    assert np.array_equal(T_norm.bgra_to_rgb(torch.from_numpy(frame)).numpy(),
                          np.asarray(J_norm.bgra_to_rgb(jnp.asarray(frame))))
    assert T_norm.norm_constants(family) == J_norm.norm_constants(family)
    x = rng.random((1, 6, 10, 3), dtype=np.float32)
    _close(T_norm.normalize_for_model(torch.from_numpy(x), family),
           J_norm.normalize_for_model(jnp.asarray(x), family))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = np.random.default_rng(4).uniform(-6, 6, 4096).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = T_act.gelu(tx).float().numpy()
    want = np.asarray(J_act.gelu(jx).astype(jnp.float32))
    if dtype == "float32":  # exact erf on both sides
        _close(got, want)
        return
    # bf16: both take the tanh form.  torch evaluates it in f32 and rounds
    # once; JAX rounds every step to bf16, which its own docstring bounds by
    # one bf16 ulp (2^-7 relative) plus 3.4e-3 absolute near zero.
    once = torch.nn.functional.gelu(tx.float(), approximate="tanh").bfloat16()
    assert torch.equal(T_act.gelu(tx), once)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=3.4e-3)


def _depth_field(seed, shape=(42, 70), metric=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    d = 3.0 + np.sin(xx / 9.0) + np.cos(yy / 7.0) + 0.3 * rng.standard_normal(shape)
    if metric:
        d[rng.random(shape) < 0.1] = 0.0  # invalid (non-positive) pixels
    return d.astype(np.float32)


@pytest.mark.parametrize("metric", [False, True])
@pytest.mark.parametrize("fg,aa", [(0.0, 2.0), (0.3, 1.0), (-0.4, 4.0)])
def test_post_process_depth_matches_jax(metric, fg, aa):
    d = _depth_field(5, metric=metric)
    got = T_post.post_process_depth(torch.from_numpy(d), metric=metric,
                                    foreground_scale=fg, aa_strength=aa)
    want = J_post.post_process_depth(jnp.asarray(d), metric=metric,
                                     foreground_scale=fg, aa_strength=aa)
    _close(got, want)


@pytest.mark.parametrize("metric", [False, True])
def test_normalize_depth_subsampled_matches_jax(metric):
    """Above SUBSAMPLE_CAP values the percentile runs on a stride subsample."""
    d = _depth_field(6, shape=(96, 128), metric=metric)
    _close(T_post.normalize_depth(torch.from_numpy(d), metric=metric),
           J_post.normalize_depth(jnp.asarray(d), metric=metric))


def test_ema_nan_seed_and_shape_change_passthrough():
    """The EMA carry starts NaN (first frame passes through), blends after,
    and a carry of another shape passes the new depth through."""
    from desktop2stereo_tpu_torch.pipeline.programs import FrameProgram, ProgramConfig
    from desktop2stereo_tpu_torch.core.registry import get_spec

    cfg = ProgramConfig(model_name="Depth-Anything-V2-Small", depth_resolution=126,
                        output_height=180, display_mode="Half-SBS", ipd=0.064,
                        depth_strength=2.0, convergence=0.0, foreground_scale=0.0,
                        aa_strength=2.0, ema_alpha=0.9, temporal_smooth=True,
                        quality="high")
    prog = FrameProgram(cfg, torch.nn.Identity(), get_spec(cfg.model_name), torch.float32)
    d1, d2 = _depth_field(7), _depth_field(8)
    nan = torch.full(d1.shape, float("nan"))
    first = prog.post_stage(torch.from_numpy(d1), nan)
    post1 = J_post.post_process_depth(jnp.asarray(d1), aa_strength=2.0)
    _close(first, post1)
    second = prog.post_stage(torch.from_numpy(d2), first)
    post2 = J_post.post_process_depth(jnp.asarray(d2), aa_strength=2.0)
    _close(second, J_post.ema(post1, post2, 0.9))
    other = prog.post_stage(torch.from_numpy(d2), torch.zeros(5, 5))
    _close(other, post2)
