"""The port's letterbox crop (`pipeline/crop.py`) against the JAX package on
the CPU: `crop_stats` (run counts exact, means within 1e-4 relative; on RGB
frames and on BGRA frames with the channel order given), `crop_from_stats`,
`CropController` over a frame sequence (the same rect on every frame) and
`apply_crop` (the clamped negative rect too).  Frames: letterboxed (2.39:1
in 16:9), pillarboxed (4:3 in 16:9), dark (a letterbox around a dark scene,
which the dark-scene gate keeps whole) and full (no bars)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.pipeline.crop as J
import desktop2stereo_tpu_torch.pipeline.crop as T
from torch_threads import one_torch_thread  # noqa: F401

SIZES = ((216, 384), (360, 640))
KINDS = ("letterbox", "pillarbox", "dark", "full")
MEAN_RTOL = 1e-4
_J_STATS = jax.jit(J.crop_stats)


def make_frame(kind, h, w, seed=0, channels=3):
    """u8 frame [h, w, channels] of textured content inside black bars."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = 128 + 80 * np.sin(xx / 13.0 + seed) * np.cos(yy / 9.0)
    scene = scene[..., None] + rng.normal(0, 25, (h, w, 3))
    if kind == "dark":
        scene = scene * 0.02
    frame = np.zeros((h, w, channels), np.uint8)
    if channels == 4:
        frame[..., 3] = 255
    content = np.clip(scene, 0, 255).astype(np.uint8)
    if kind in ("letterbox", "dark"):
        ph = int(round(w / 2.39))
        top = (h - ph) // 2
        frame[top:top + ph, :, :3] = content[top:top + ph]
    elif kind == "pillarbox":
        pw = int(round(h * 4 / 3))
        left = (w - pw) // 2
        frame[:, left:left + pw, :3] = content[:, left:left + pw]
    else:
        frame[..., :3] = content
    return frame


def _assert_stats_match(t, j):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_array_equal(t[[0, 1, 4, 5]], j[[0, 1, 4, 5]])
    np.testing.assert_allclose(t[[2, 3]], j[[2, 3]], rtol=MEAN_RTOL, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_crop_stats_match_jax(kind, size):
    rgb = make_frame(kind, *size)
    t = T.crop_stats(torch.from_numpy(rgb))
    assert t.dtype == torch.float32 and t.shape == (6,)
    _assert_stats_match(t.numpy(), _J_STATS(jnp.asarray(rgb)))


@pytest.mark.parametrize("kind", KINDS)
def test_crop_stats_of_bgra_match_jax_on_its_rgb(kind):
    """The CLI's stats read a BGRA capture with the channel order given; the
    JAX CLI reverses the channels (`frame[..., 2::-1]`)."""
    bgra = make_frame(kind, *SIZES[1], channels=4)
    bgra[..., 0] //= 3  # channels differ, so a wrong order would show
    t = T.crop_stats(torch.from_numpy(bgra), T.BGR)
    _assert_stats_match(t.numpy(), _J_STATS(jnp.asarray(bgra[..., 2::-1])))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_crop_from_stats_matches_jax(kind, size):
    rgb = make_frame(kind, *size)
    h, w = size
    t = T.crop_from_stats(T.crop_stats(torch.from_numpy(rgb)).numpy(), w, h)
    j = J.crop_from_stats(np.asarray(_J_STATS(jnp.asarray(rgb))), w, h)
    assert t == j
    if kind == "letterbox":
        assert t[1] > 0 and t[3] < 1 and (t[0], t[2]) == (0.0, 1.0)
    elif kind == "pillarbox":
        assert t[0] > 0 and t[2] < 1 and (t[1], t[3]) == (0.0, 1.0)
    else:
        assert t == T.FULL


def test_tiny_frames_are_never_cropped():
    rgb = make_frame("letterbox", 48, 96)
    assert T.crop_from_stats(T.crop_stats(torch.from_numpy(rgb)).numpy(), 96, 48) == T.FULL


@pytest.mark.parametrize("poll_every,reset", [(1, 3), (2, 2)])
def test_crop_controller_matches_jax_over_a_sequence(poll_every, reset):
    """Letterbox, a moved letterbox (past the deadband), full frames (the
    reset needs `reset` full results), letterbox again, dark frames."""
    h, w = SIZES[0]
    seq = ([make_frame("letterbox", h, w, seed=i) for i in range(3)]
           + [np.roll(make_frame("letterbox", h, w, seed=3), 6, axis=0) for _ in range(2)]
           + [make_frame("full", h, w, seed=i) for i in range(5)]
           + [make_frame("letterbox", h, w, seed=9)]
           + [make_frame("dark", h, w, seed=i) for i in range(4)])
    t_ctl = T.CropController(full_hits_reset=reset, poll_every=poll_every)
    j_ctl = J.CropController(full_hits_reset=reset, poll_every=poll_every)
    rects = []
    for frame in seq:
        t_rect = t_ctl.update(torch.from_numpy(frame))
        j_rect = j_ctl.update(jnp.asarray(frame))
        assert t_rect == j_rect
        assert (t_ctl.full_hits, t_ctl.active) == (j_ctl.full_hits, j_ctl.active)
        rects.append(t_rect)
    assert len(set(rects)) >= 3  # the sequence moved the crop and reset it


@pytest.mark.parametrize("rect", [
    T.FULL, (0.0, 0.125, 1.0, 0.75), (0.1, 0.2, 0.5, 0.5), (-0.05, 0.0, 1.0, 1.0),
    (0.0, -0.2, 1.2, 0.5), (0.9, 0.9, 0.5, 0.5), (0.5, 0.5, 0.0, 0.0)])
def test_apply_crop_matches_jax(rect):
    img = np.arange(50 * 70 * 4, dtype=np.int32).reshape(50, 70, 4) % 251
    t = T.apply_crop(torch.from_numpy(img), rect)
    j = J.apply_crop(jnp.asarray(img), rect)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


class _Recorder:
    """A stand-in ProgramCache: records the frames and warm-up shapes."""

    device = torch.device("cpu")

    def __init__(self):
        self.frames, self.warmed = [], []

    def __call__(self, frame, stream=0):
        self.frames.append((frame, stream))
        return frame, None

    def warmup(self, shape, steps=2):
        self.warmed.append(tuple(shape))
        return {}


def test_crop_program_auto_crops_bgra_per_stream():
    base = _Recorder()
    prog = T.CropProgram(base)
    assert prog.device == base.device and prog.base is base
    lb = make_frame("letterbox", *SIZES[1], channels=4)
    full = make_frame("full", *SIZES[1], channels=4)
    prog(lb, stream=0)
    prog(torch.from_numpy(full), stream=1)
    (f0, s0), (f1, s1) = base.frames
    rect = J.crop_from_stats(np.asarray(_J_STATS(jnp.asarray(lb[..., 2::-1]))), 640, 360)
    want = np.asarray(J.apply_crop(jnp.asarray(lb), rect))
    assert (s0, s1) == (0, 1) and f0.is_contiguous()
    np.testing.assert_array_equal(f0.numpy(), want)
    assert tuple(f1.shape) == full.shape  # stream 1 detects its own (none)
    assert set(prog.controllers) == {0, 1}
    prog.warmup(lb.shape)
    assert base.warmed == [lb.shape]  # auto starts full-frame


def test_crop_program_manual_rect_and_its_warmup():
    base = _Recorder()
    rect = (0.1, 0.25, 0.5, 0.5)
    prog = T.CropProgram(base, rect)
    frame = make_frame("full", 100, 200, channels=4)
    prog(frame)
    np.testing.assert_array_equal(base.frames[0][0].numpy(),
                                  np.asarray(J.apply_crop(jnp.asarray(frame), rect)))
    prog.warmup((100, 200, 4))
    assert base.warmed == [(50, 100, 4)]
