"""The window's arithmetic: a rate over the whole window, percentiles over
every frame in it, and a seeded sample of the frames delivered in it.

Everything here takes plain numbers, so the tests can drive it with
synthetic timestamps.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Iterable, List, Optional, Sequence, Tuple


def in_window(t: float, w0: float, w1: float) -> bool:
    return w0 <= t < w1


def rate(times: Iterable[float], w0: float, w1: float) -> float:
    """Events whose time falls in [w0, w1), over the window's seconds."""
    return sum(1 for t in times if in_window(t, w0, w1)) / (w1 - w0)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the two
    nearest ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies_ms(deliveries: Iterable[Tuple[float, float]], w0: float, w1: float) -> List[float]:
    """(capture time, delivery time) pairs → the latency in ms of every
    frame delivered in [w0, w1)."""
    return [(t1 - t0) * 1e3 for t0, t1 in deliveries if in_window(t1, w0, w1)]


class Reservoir:
    """A uniform sample of at most `k` of the items offered (Algorithm R),
    drawn from `seed`; safe to offer from several threads.  `offer(make)`
    calls `make()` only for an item that enters the sample, so an item
    left out costs nothing."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.items: List = []
        self.seen = 0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def offer(self, make) -> bool:
        with self._lock:
            self.seen += 1
            if len(self.items) < self.k:
                slot: Optional[int] = len(self.items)
                self.items.append(None)
            else:
                j = self._rng.randrange(self.seen)
                slot = j if j < self.k else None
            if slot is None:
                return False
            self.items[slot] = make()
            return True
