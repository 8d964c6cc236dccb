"""K1 (the both-eyes DIBR kernel, `csrc/dibr_pair.cu`) against its
roofline, %: its bytes (each input read once, the u8 frame written once)
over the HBM bandwidth, for every tail call in the slice, divided by the
device time of the kernels matching K1's name inside the `d2s.tail`
ranges."""

import re

from stereobench.roofline import HBM_BYTES_PER_S, dibr_half_bytes

PATTERN = re.compile(r"\bdibr_pair_kernel\b")


def read(run):
    if run.slice is None:
        return None
    tails = run.slice.ranges("d2s.tail")
    kernels = run.slice.kernels_in(tails, PATTERN)
    if not kernels:
        return None
    t = sum(float(e["dur"]) for e in kernels) / 1e6
    least = dibr_half_bytes(*run.tail) * len(tails) / HBM_BYTES_PER_S
    return 100.0 * least / t
