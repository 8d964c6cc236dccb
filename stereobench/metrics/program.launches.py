"""Kernel launches a step (`cudaLaunchKernel*`, `cuLaunchKernel*`,
`cudaGraphLaunch`: the trace's runtime and driver calls) made on the
compute thread inside the program's stage ranges (`d2s.preprocess`,
`d2s.model`, `d2s.tail` or `d2s.post` and `d2s.stereo`) in the traced
slice, over its steps (`d2s.model` ranges).  A graph replay is one launch."""

from stereobench.spans import LAUNCH, in_stages


def read(run):
    got = None if run.slice is None else in_stages(run.slice, LAUNCH)
    if not got or not got[0]:
        return None
    calls, steps = got
    return len(calls) / steps
