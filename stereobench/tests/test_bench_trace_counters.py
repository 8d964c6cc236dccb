"""The trace's arithmetic on a synthetic trace, and the operation, byte and
FLOP counters against counts by hand."""

import re

import pytest
import torch

from stereobench import harness, manifest, roofline
from stereobench.record import RANGE_DISPATCH
from stereobench.trace import NO_RANGE, TraceSlice
from stereobench.tests.bench_helpers import ROOT, config


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic_trace():
    """Five 100 µs steps from t=1000 µs: a dispatch range (d2s.model inside
    it) and, on the device, a 30 µs K2 kernel and a 20 µs gemm inside the
    step's gpu d2s.model range, a 10 µs K1 kernel in its d2s.tail range; the
    device idle the rest of the step."""
    ev = []
    for i in range(5):
        t = 1000.0 + 100.0 * i
        ev += [_ev("user_annotation", RANGE_DISPATCH, t, 40.0),
               _ev("user_annotation", "d2s.model", t + 5, 20.0),
               _ev("user_annotation", "d2s.tail", t + 26, 10.0),
               _ev("gpu_user_annotation", "d2s.model", t + 40, 55.0),
               _ev("gpu_user_annotation", "d2s.tail", t + 95, 10.0),
               _ev("kernel", "attention_fwd_kernel<64>", t + 40, 30.0),
               _ev("kernel", "sm90_xmma_gemm_bf16", t + 70, 20.0),
               _ev("kernel", "dibr_pair_kernel", t + 95, 10.0)]
    return ev


def test_slice_busy_idle_and_ranges():
    host = [10.0 + 1e-4 * i for i in range(5)]  # the steps' host clock starts
    s = TraceSlice(synthetic_trace(), host, warm=1)
    # the slice: from step 1's dispatch (1100) to step 4's (1400): 3 whole steps
    assert (s.start, s.end, s.steps) == (1100.0, 1400.0, 3)
    assert s.seconds == pytest.approx(300e-6)
    assert s.busy_s == pytest.approx(3 * 60e-6)
    assert 1 - s.busy_s / s.seconds == pytest.approx(0.4)
    assert s.device_ms_per_range(["d2s.model"]) == pytest.approx(0.050)
    assert s.device_ms_per_range(["d2s.tail"]) == pytest.approx(0.010)
    assert s.device_ms_per_range(["d2s.post", "d2s.stereo"]) is None
    k2 = s.kernels_in(s.ranges("d2s.model"), re.compile(r"\battention_fwd_kernel\b"))
    assert len(k2) == 3
    a, b = s.host_bounds()
    assert a == pytest.approx(10.0 + 1e-4) and b == pytest.approx(10.0 + 4e-4)


def test_breakdown_labels_idle_gaps_by_the_open_host_range():
    s = TraceSlice(synthetic_trace(), [0.0] * 5, warm=1)
    ops = dict((n, v) for n, v in s.top_ops())
    assert ops["attention_fwd_kernel<64>"] == pytest.approx(90e-6)
    assert ops["dibr_pair_kernel"] == pytest.approx(30e-6)  # clipped at both ends
    gaps = dict((n, v) for n, v in s.idle_gaps())
    # each step idles 0-40 µs (inside bench.dispatch, 5-25 in d2s.model
    # at the gap's start: the gap begins at the dispatch's start) and 105-140
    assert sum(gaps.values()) == pytest.approx(s.seconds - s.busy_s)
    assert set(gaps) <= {RANGE_DISPATCH, "d2s.model", "d2s.tail", NO_RANGE}


def test_kernel_counters_by_hand():
    # K2 at [8, 778, 16, 64]: q kᵀ and p v, 2·778²·64 each a head
    assert roofline.attention_ops([(8, 778, 16, 64)]) == 4 * 8 * 16 * 778 * 778 * 64
    assert roofline.attention_ops([(1, 10, 2, 4), (2, 3, 1, 8)]) == 4 * (2 * 100 * 4 + 2 * 9 * 8)
    # K1 at a 4K eye: f32 rgb and depth in, the u8 frame out
    eh, ew = 2160, 1920
    assert roofline.dibr_half_bytes(1, eh, ew) == 12 * eh * ew + 4 * eh * ew + 6 * eh * ew
    t = roofline.dibr_half_bytes(1, eh, ew) / roofline.HBM_BYTES_PER_S
    assert t * 1e3 == pytest.approx(0.0272, abs=1e-4)  # PERF.md's bound
    assert roofline.dibr_half_bytes(8, 3, 5) == 8 * roofline.dibr_half_bytes(1, 3, 5)


def test_model_flops_by_hand_at_one_shape():
    """The reference's FLOP count of a DINOv2 trunk equals the count by hand:
    patch embedding, then per layer qkv, q kᵀ, p v, proj, fc1, fc2."""
    cfg = dict(config("da2-large-518"), num_hidden_layers=2, out_indices=[0, 1])
    fam = manifest.family(cfg)
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        trunk = fam.build(cfg).backbone
        counter = FlopCounterMode(display=False)
        with counter:
            trunk(torch.empty(1, 3, 294, 518))
    D, M, p, n = 1024, 4096, 14, 21 * 37
    N = n + 1
    layer = 2 * N * D * 3 * D + 4 * N * N * D + 2 * N * D * D + 2 * 2 * N * D * M
    assert counter.get_total_flops() == 2 * n * p * p * 3 * D + 2 * layer


def test_cell_counts():
    cfg = config("da2-large-518")  # eight batched 1080p feeds
    flops, shapes = harness.model_counts(manifest.family(cfg), cfg, (1080, 1920), 8)
    assert shapes == [(8, 778, 16, 64)] * 24
    assert 0.6e12 < flops < 0.8e12
    cell = manifest.load_cell("depthpro-4k", ROOT)
    flops, shapes = harness.model_counts(manifest.family(cell.config), cell.config,
                                         (2160, 3840), 1)
    assert shapes == [(35, 730, 16, 64)] * 24 + [(1, 730, 16, 64)] * 24
    assert 30e12 < flops < 45e12
