"""Host ms a step of the call into the program (every launch of the step
enqueued), timed around the program object the engine is handed, over the
window's steps before the profiler started."""

from statistics import fmean


def read(run):
    end = run.profiled_from if run.profiled_from is not None else run.window[1]
    xs = [st.dispatch_s for st in run.steps if run.window[0] <= st.t_dispatch < end]
    return fmean(xs) * 1e3 if xs else None
