"""Median ms from the start of a frame's `d2s.finish` span (the wait on its
copies, the put into the output mailbox) to the start of its `d2s.sink`
push, over the frames delivered in the window before the profiler
started."""

from stereobench.spans import median_ms


def read(run):
    return median_ms(run, lambda p: p["d2s.sink"][1] - p["d2s.finish"][1])
