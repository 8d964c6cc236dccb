"""Median ms from the end of a frame's `d2s.dispatch` span to the start of
its `d2s.finish`, over the frames delivered in the window before the
profiler started: the one-frame software pipeline's hold, in which the
next frame is dispatched."""

from stereobench.spans import median_ms


def read(run):
    return median_ms(run, lambda p: p["d2s.finish"][1] - p["d2s.dispatch"][2])
