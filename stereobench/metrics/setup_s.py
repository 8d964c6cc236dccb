"""From the process's start to the start of the window: imports, the
kernels' build or load, weights, frames, the warm-up and the lead-in."""


def read(run):
    return run.setup_s
