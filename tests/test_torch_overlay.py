"""The port's FPS overlay (`ops/overlay.py`) against the JAX package on the
CPU: the glyph mask equal, `overlay_text` equal on u8 frames and within 1e-6
on float32 frames (the mask is 0 or 1, so the blend picks a pixel or the
colour), and `FpsOverlay` on host frames over its mask-rebuild interval."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.ops.overlay as J
import desktop2stereo_tpu_torch.ops.overlay as T
from torch_threads import one_torch_thread  # noqa: F401

F32_ATOL = 1e-6
_J_BLEND = jax.jit(J.overlay_text)


@pytest.mark.parametrize("text,h,w", [("FPS: 59.9", 120, 320), ("FPS: 1234.5", 1080, 1920),
                                      ("0123456789:. FPS?", 60, 90), ("FPS: 7.0", 8, 8)])
def test_text_mask_matches_jax(text, h, w):
    t, j = T.text_mask(text, h, w), J.text_mask(text, h, w)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("h,w", [(120, 320), (540, 960)])
@pytest.mark.parametrize("color", [(0.0, 255.0, 0.0), (255.0, 12.5, 200.0)])
def test_overlay_text_u8_exact(h, w, color):
    rng = np.random.default_rng(h + w)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = J.text_mask("FPS: 42.0", h, w)
    t = T.overlay_text(torch.from_numpy(rgb), torch.from_numpy(mask), color)
    j = jax.jit(J.overlay_text, static_argnums=2)(jnp.asarray(rgb), jnp.asarray(mask), color)
    assert t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_overlay_text_f32():
    rng = np.random.default_rng(3)
    rgb = (rng.random((240, 427, 3)) * 255).astype(np.float32)
    mask = J.text_mask("FPS: 120.3", 240, 427)
    t = T.overlay_text(torch.from_numpy(rgb), torch.from_numpy(mask))
    j = _J_BLEND(jnp.asarray(rgb), jnp.asarray(mask))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=F32_ATOL)


def test_fps_overlay_on_host_frames_matches_jax():
    """numpy in, numpy out; the mask is rebuilt every `interval` frames, so
    an fps change shows on the frame the JAX overlay shows it."""
    rng = np.random.default_rng(5)
    t_ov, j_ov = T.FpsOverlay(interval=3), J.FpsOverlay(interval=3)
    for i, fps in enumerate([30.0, 31.5, 99.9, 100.2, 7.0, 8.0, 1234.5]):
        frame = rng.integers(0, 256, (180, 320, 3), dtype=np.uint8)
        t = t_ov(frame, fps)
        assert isinstance(t, np.ndarray) and t.dtype == np.uint8
        np.testing.assert_array_equal(t, np.asarray(j_ov(frame, fps)), err_msg=f"frame {i}")


def test_fps_overlay_keeps_a_tensor_on_its_device():
    frame = torch.zeros(90, 160, 3, dtype=torch.uint8)
    out = T.FpsOverlay()(frame, 60.0)
    assert isinstance(out, torch.Tensor) and out.device == frame.device
    assert int(out[..., 1].max()) == 255 and int(out[..., 0].max()) == 0
