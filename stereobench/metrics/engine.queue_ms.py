"""Median ms from a frame's capture (the start of the engine's `d2s.grab`
span, its `t0`) to the compute thread's `taken` mark, over the frames
delivered in the window before the profiler started: the capture mailbox's
wait, latest wins."""

from stereobench.spans import median_ms


def read(run):
    return median_ms(run, lambda p: p["taken"][1] - p["d2s.grab"][1])
