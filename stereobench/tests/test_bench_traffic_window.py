"""Seeded frames, and the window's arithmetic on synthetic timestamps."""

import statistics

import numpy as np
import pytest

from stereobench import traffic
from stereobench.window import Reservoir, latencies_ms, percentile, rate

MIX = dict(frame=[216, 384, 4], generator="desktop", ring=3, feeds=2)
BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("generator", ["desktop", "synthetic"])
def test_same_seed_same_frames(generator):
    mix = dict(MIX, generator=generator)
    a, b = traffic.feed_rings(mix, BIG_SEED), traffic.feed_rings(mix, BIG_SEED)
    c = traffic.feed_rings(mix, BIG_SEED + 1)
    assert all(np.array_equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    assert not all(np.array_equal(x, y) for ra, rc in zip(a, c) for x, y in zip(ra, rc))
    assert not np.array_equal(a[0][0], a[1][0])  # feeds differ
    assert all(f.shape == (216, 384, 4) and f.dtype == np.uint8 for r in a for f in r)


def test_seeds_beyond_32_bits_and_negative():
    for s in (0, 2 ** 31, 2 ** 40 + 7, -5):
        assert 0 <= traffic.derive_seed(s, 1, 0) < 2 ** 63
    assert traffic.derive_seed(7, 1, 0) != traffic.derive_seed(7, 1, 1)


def test_ring_source_cycles_the_ring_itself():
    ring = traffic.feed_rings(MIX, 3)[0]
    src = traffic.RingSource(ring)
    got = [src.grab() for _ in range(7)]
    assert [id(g) for g in got] == [id(ring[i % 3]) for i in range(7)]


def test_rate_counts_the_whole_window():
    times = np.arange(0.0, 20.0, 0.01)  # 100 a second
    assert rate(times, 5.0, 15.0) == pytest.approx(100.0, rel=1e-9)
    # a stall of 4 s inside the window: the rate drops by its share
    stalled = [t for t in times if not 8.0 <= t < 12.0]
    assert rate(stalled, 5.0, 15.0) == pytest.approx(60.0, rel=1e-9)


def test_percentiles_over_every_frame_with_a_stall():
    # 1 000 frames 50 ms late, then a 2 s stall whose 60 frames wait up to 2 s
    pairs = [(t, t + 0.05) for t in np.arange(0.0, 10.0, 0.01)]
    pairs += [(10.0 + i / 30, 12.05) for i in range(60)]
    lat = latencies_ms(pairs, 0.0, 13.0)
    assert len(lat) == 1060
    assert percentile(lat, 50) == pytest.approx(50.0, abs=1e-6)
    assert percentile(lat, 95) > 50.0  # the stall's frames reach the tail
    want = np.percentile(lat, [50, 95])
    assert [percentile(lat, 50), percentile(lat, 95)] == pytest.approx(list(want))
    # a median of per-second chunks would hide the stall entirely
    assert statistics.median(percentile(lat[i:i + 100], 95) for i in range(0, 1000, 100)) \
        == pytest.approx(50.0, abs=1e-6)


def test_deliveries_outside_the_window_do_not_count():
    pairs = [(0.0, 0.5), (1.0, 1.2), (2.0, 3.5)]
    assert latencies_ms(pairs, 1.0, 3.0) == pytest.approx([200.0])


def test_reservoir_is_seeded_and_uniform():
    def sample(seed):
        r = Reservoir(5, seed)
        for i in range(1000):
            r.offer(lambda i=i: i)
        return r.items

    assert sample(1) == sample(1) and sample(1) != sample(2)
    counts = np.zeros(10)
    for seed in range(2000):
        for x in sample(seed):
            counts[x // 100] += 1
    assert counts.min() > 0.8 * counts.mean()  # every decile of the stream is drawn


def test_reservoir_makes_only_what_it_keeps():
    made = []
    r = Reservoir(2, 0)
    for i in range(50):
        r.offer(lambda i=i: made.append(i) or i)
    assert len(made) < 50 and set(r.items) <= set(made)
