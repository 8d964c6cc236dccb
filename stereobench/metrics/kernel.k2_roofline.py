"""K2 (the attention kernel, `csrc/attention.cu`) against its roofline, %:
the operations of every attention call of the model's steps in the slice
(4·B·H·N²·d a call, from the reference's shapes at the step's batch) over
the bf16 tensor-core peak, divided by the device time of the kernels
matching K2's name inside those steps' `d2s.model` ranges."""

import re

from stereobench.roofline import BF16_OPS_PER_S, attention_ops

PATTERN = re.compile(r"\battention_fwd_kernel(_relpos)?\b")


def read(run):
    if run.slice is None:
        return None
    steps = run.slice.ranges("d2s.model")
    kernels = run.slice.kernels_in(steps, PATTERN)
    if not kernels:
        return None
    t = sum(float(e["dur"]) for e in kernels) / 1e6
    least = attention_ops(run.attention_shapes) * len(steps) / BF16_OPS_PER_S
    return 100.0 * least / t
