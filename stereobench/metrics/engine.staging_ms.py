"""Host ms a step in the engine's pinned staging upload (the harness's
wrapper around the engine instance's upload call), over the window's
steps before the profiler started."""

from statistics import fmean


def read(run):
    end = run.profiled_from if run.profiled_from is not None else run.window[1]
    xs = [st.upload_s for st in run.steps if run.window[0] <= st.t_dispatch < end]
    return fmean(xs) * 1e3 if xs and any(xs) else None
