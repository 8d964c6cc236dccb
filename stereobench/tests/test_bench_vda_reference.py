"""The program's `VideoDepthAnything` against the plain reference
(`reference/vda.py`) at tiny widths on the CPU in float32, on the same
seeded weights: the first call, a step on the same frame, steps on
distinct frames, and a batched step through the frame program's model
stage with a stale row.

Every comparison is relative to the reference's largest value and held
under 1e-4: both sides compute in float32, in different orders (the
program's resizes are table products, its transposed convolutions a
product and a depth-to-space, its attention a fused kernel's plain path),
which moves the last bits of each of some thirty layers (1.2e-6 to
7.5e-6 measured); bfloat16's unit round-off, 3.9e-3, is 39 times the
tolerance, so either side computed in bfloat16 would fail it.
The tests import the program; the reference does not."""

import pytest
import torch

from stereobench import weights
from stereobench.reference import vda as ref_vda
from stereobench.tests.bench_helpers import config

from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.models.vda import VideoDepthAnything
from desktop2stereo_tpu_torch.pipeline import programs

TOL = 1e-4
# ViT widths 64 (4 heads, 4 layers, all four hidden states to the neck);
# temporal modules on 64, 64, 32 and 32 channels (32 GroupNorm groups, 8 heads)
SMALL = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128, num_hidden_layers=4,
             out_indices=[0, 1, 2, 3], neck_hidden_sizes=[32, 64, 64, 64], fusion_hidden_size=32)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = dict(config("vda-large-518"), **SMALL)
    ref = ref_vda.build(cfg)
    port = VideoDepthAnything(64, 4, 4, 128, (0, 1, 2, 3), (32, 64, 64, 64), 32)
    state = weights.draw(ref, cfg["init"], 21, torch.device("cpu"), torch.float32)
    ref.load_state_dict(state, strict=True)
    port.load_state_dict(state, strict=True)
    return ref.eval(), port.eval()


def frames(n, batch=2, seed=0):
    """n NHWC inputs of 70x126 (5 x 9 patches; the sites hold 45, 15, 45
    and 180 pixels)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(batch, 70, 126, 3, generator=g) for _ in range(n)]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _close(got, want):
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


@torch.no_grad()
def test_first_and_steps_against_the_reference(pair):
    ref, port = pair
    x0, x1, x2 = frames(3)
    depth, carry = port.first(x0)
    want, entries = ref(x0.permute(0, 3, 1, 2))
    want_carry = ref_vda.advance(None, entries)
    _close(depth, want)
    assert len(carry) == 8 and [c.shape[2] for c in carry] == [ref_vda.CARRY] * 8
    for got, w in zip(carry, want_carry):
        _close(got, w)
    # a step on the same frame, then on distinct frames; each side carries its own
    for x in (x0, x1, x2):
        depth, carry = port.step(x, carry)
        want, entries = ref(x.permute(0, 3, 1, 2), want_carry)
        want_carry = ref_vda.advance(want_carry, entries)
        _close(depth, want)
        for got, w in zip(carry, want_carry):
            _close(got, w)
    # the window moved: its last entries hold three different frames
    assert not torch.equal(carry[0][:, :, -1], carry[0][:, :, -2])


@torch.no_grad()
def test_a_batched_step_with_a_stale_row_against_the_reference(pair):
    """The frame program's model stage over two streams, the second row not
    fresh: both rows' depth as the reference computes it from their own
    carry, the fresh row's carry advanced, the stale row's kept bit for bit."""
    ref, port = pair
    cfg = programs.ProgramConfig(
        model_name="Video-Depth-Anything-Small", depth_resolution=126, output_height=70,
        display_mode="Half-SBS", ipd=0.064, depth_strength=2.0, convergence=0.0,
        foreground_scale=0.0, aa_strength=2.0, ema_alpha=0.9, temporal_smooth=True,
        quality="high")
    program = programs.FrameProgram(cfg, port, get_spec("Video-Depth-Anything-Small"),
                                    compute_dtype=torch.float32, streams=2)
    x0, x1, x2 = frames(3, seed=1)
    _, carry = program.model_stage(x0)
    _, carry = program.model_stage(x1, carry, torch.tensor([True, True]))
    raw, out = program.model_stage(x2, carry, torch.tensor([True, False]))
    want, entries = ref(x2.permute(0, 3, 1, 2), carry)
    _close(raw, want)
    advanced = ref_vda.advance(carry, entries)
    for c_in, got, w in zip(carry, out, advanced):
        assert torch.equal(got[1], c_in[1])
        _close(got[:1], w[:1])
