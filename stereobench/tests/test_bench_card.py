"""The harness on the card (marked `cuda`; each skips on a host without a
CUDA device): `python -m pytest stereobench/tests -q` on the card host."""

import time

import pytest
import torch

from stereobench import harness, manifest, weights
from stereobench.reference import frame as F
from stereobench.run import verdict
from stereobench.tests.bench_helpers import config, cuda, tiny_copy  # noqa: F401

pytestmark = pytest.mark.cuda
INIT = {"layer_scale": 1.0, "token_std": 0.02, "bias_std": 0.02}


def _small_cfg():
    return dict(config("da2-large-518"), hidden_size=384, num_attention_heads=6,
                num_hidden_layers=12, intermediate_size=1536, out_indices=[2, 5, 8, 11],
                neck_hidden_sizes=[48, 96, 192, 384], fusion_hidden_size=64)


def test_weights_drawn_on_the_card_repeat_from_the_seed(cuda):
    cfg = _small_cfg()
    with torch.device("meta"):
        ref = manifest.family(cfg).build(cfg)
    a = weights.draw(ref, INIT, 2 ** 40 + 3, cuda, torch.bfloat16)
    b = weights.draw(ref, INIT, 2 ** 40 + 3, cuda, torch.bfloat16)
    c = weights.draw(ref, INIT, 2 ** 40 + 4, cuda, torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(v.dtype == torch.bfloat16 and v.device.type == "cuda" for v in a.values())


@torch.no_grad()
def test_the_reference_on_the_card_is_the_cpus(cuda):
    """TF32 off: the card's float32 reference agrees with the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_cfg()
    fam = manifest.family(cfg)
    with torch.device("meta"):
        shapes = fam.build(cfg)
    state = weights.draw(shapes, INIT, 5, torch.device("cpu"), torch.float32)
    x = torch.randn(2, 3, 126, 224, generator=torch.Generator().manual_seed(0))
    out = []
    for dev in (torch.device("cpu"), cuda):
        ref = fam.build(cfg).to(dev)
        ref.load_state_dict({k: v.to(dev) for k, v in state.items()})
        raw = ref.eval()(x.to(dev))
        out.append(torch.stack([F.display_depth(r, False, 0.0, 2.0) for r in raw]).cpu())
    assert (out[0] - out[1]).abs().max() < 1e-4


@pytest.mark.parametrize("cell", ["tiny-batched", "tiny-single"])
def test_a_tiny_cell_runs_correct_on_the_card(cuda, tmp_path, cell):
    root = tiny_copy(tmp_path)
    c = manifest.load_cell(cell, root)
    out = harness.run_cell(c, 77, 2.0, True, cuda, time.perf_counter())
    result, _ = verdict(c, out)
    assert result["correct"], result["check"]
    m = result["metrics"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    for name in ("program.model_ms", "program.tail_ms", "device.idle", "device.mfu",
                 "kernel.k2_roofline", "kernel.k1_roofline"):
        assert name in m, sorted(m)
    assert 0 < m["kernel.k2_roofline"]["value"] <= 100
    assert 0 < m["kernel.k1_roofline"]["value"] <= 100
    assert 0 <= m["device.idle"]["value"] <= 100
