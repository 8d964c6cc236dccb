"""Host ms a step in runtime calls that hold the host (`cuda*Synchronize`,
a synchronous `cudaMemcpy`, `cudaMalloc`, `cudaFree`, `cudaHostAlloc` and
their driver forms) on the compute thread inside the program's stage
ranges in the traced slice, over its steps; 0 where the slice's stage
ranges hold runtime calls and none of these."""

from stereobench.spans import BLOCKING, LAUNCH, in_stages


def read(run):
    if run.slice is None or not (launched := in_stages(run.slice, LAUNCH)) or not launched[0]:
        return None
    calls, steps = in_stages(run.slice, BLOCKING)
    return sum(float(e["dur"]) for e in calls) / 1e3 / steps
