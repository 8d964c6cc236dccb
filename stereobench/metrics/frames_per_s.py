"""Frames delivered to the sinks in the window, all feeds, over its seconds."""

from stereobench.window import rate


def read(run):
    return rate((d.t for d in run.deliveries), *run.window)
