"""The check's stateless path holds still: one fixed recorded sample of the
tiny batched DA-V2 cell (`bench_helpers.TINY_DA2`, `TINY_MIX`), made from
seeds alone and passed through `record.Recorder` as the timed path passes
it, gives the check's numbers bit for bit as the harness computed them
before the stateful stage was added, on each torch build they were
recorded with."""

import numpy as np
import pytest
import torch

from stereobench import check, manifest, record, traffic, weights
from stereobench.reference import frame as F
from stereobench.tests.bench_helpers import TINY_DA2, TINY_MIX, config
from stereobench.window import Reservoir

# check.reference_numbers on `fixed_sample()` by the check as it was before
# the stateful stage was added, with one thread, by torch build: the seeded
# bfloat16 draw and the reference's convolutions differ between builds
PARENT = {
    "2.13.0+cpu": {  # x86-64
        "encoder_error_ratio": 83.81920929055394, "decoder_error_ratio": 198.75330522133885,
        "decoder_error_ratio.folded": 187.69700500770475,
        "depth_post_abs.worst": 0.3227200210094452, "sbs_off_share.worst": 0.0625,
        "sbs_mean_lsb.worst": 5.8125, "encoder_mean_abs": 1.1967093738508814,
        "decoder_mean_abs": 0.4703023482342155},
    "2.11.0+cu128": {  # the card host's CPU
        "encoder_error_ratio": 66.14038718241387, "decoder_error_ratio": 2392.8553599126567,
        "decoder_error_ratio.folded": 2084.4265512687475,
        "depth_post_abs.worst": 0.3227200210094452, "sbs_off_share.worst": 0.0625,
        "sbs_mean_lsb.worst": 5.8125, "encoder_mean_abs": 1.2126310430927043,
        "decoder_mean_abs": 0.581853165918467},
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixed_sample():
    """(family, cfg, weights, rings, steps, sample): three batched calls of
    two feeds whose stages are seeded tensors of the tiny cell's shapes,
    recorded by `record.Recorder`, and three of their deliveries sampled,
    each u8 frame the reference's Half-SBS frame with a band altered."""
    cpu = torch.device("cpu")
    cfg = dict(config("da2-large-518"), **TINY_DA2)
    fam = manifest.family(cfg)
    rings = traffic.feed_rings(TINY_MIX, 11)
    with torch.device("meta"):
        shapes = fam.build(cfg)
    state = weights.draw(shapes, cfg["init"], 12, cpu, torch.bfloat16)
    g = torch.Generator().manual_seed(13)
    rec = record.Recorder(rings, Reservoir(3, 14), batched=True)
    ring = TINY_MIX["ring"]
    for k in range(3):
        rec.staged(0.0, [(f, (k + f) % ring, k + f / 10) for f in range(2)])
        enc = [torch.randn(2, 9, 384, generator=g).to(torch.bfloat16) for _ in range(4)]
        raw = torch.rand(2, 28, 56, generator=g) + 0.1
        depth = torch.rand(2, 28, 56, generator=g)
        rec.dispatched(float(k), 0.0, [True, k != 1],
                       {"enc": {"backbone": enc}, "raw": raw.to(torch.bfloat16), "depth": depth})
    sample = []
    for k, f in ((1, 0), (2, 1), (2, 0)):
        t0 = k + f / 10
        st = rec._stages_of(f, t0)
        planar = F.planar_rgb(torch.from_numpy(rings[f][(k + f) % ring]), (64, 112))
        sbs = F.half_sbs(planar, st["depth"].float(), ipd=0.064, depth_strength=2.0,
                         convergence=0.0).numpy().copy()
        sbs[: 2 + k] = 255 - sbs[: 2 + k]
        sample.append((f, t0, sbs, st))
    return fam, cfg, state, rings, rec.steps, sample


@torch.no_grad()
def test_the_stateless_check_gives_the_parents_numbers_bit_for_bit():
    if torch.__version__ not in PARENT:
        pytest.skip(f"the numbers were recorded with torch {', '.join(PARENT)}, not "
                    f"{torch.__version__}")
    fam, cfg, state, rings, steps, sample = fixed_sample()
    numbers = check.reference_numbers(fam, cfg, cfg["display"], state, rings, steps, sample,
                                      (64, 112), torch.device("cpu"))
    assert numbers == PARENT[torch.__version__]
    assert not any(np.isnan(v) for v in numbers.values())
