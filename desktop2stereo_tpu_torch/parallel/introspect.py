"""Kernel-launch counts of one call, the proof that K2 and K4 ran per shard.

The JAX package proves that its Pallas kernels survive a sharded trace by
counting `pallas_call` equations in the jaxpr (`parallel/introspect.py:
count_prims` there).  The port has no graph to inspect: each kernel
wrapper counts its own launches (`ops/kernels/build.py:CudaLibrary.
entry_launches`, one per launch; a launch recorded into a CUDA graph is
counted apart, in `captured_launches`), so a call's launches on this rank
are the counts after it less the counts before.  CPU tensors take the plain versions and launch nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple


def _libraries():
    from desktop2stereo_tpu_torch.ops.kernels import (
        attention, dibr, dibr_fill, quant_matmul, warp)

    return (attention.KERNEL, dibr.KERNEL, warp.KERNEL, dibr_fill.KERNEL, quant_matmul.KERNEL)


def launch_counts() -> Dict[str, int]:
    """{kernel entry: launches so far in this process}, every entry of the
    five kernel libraries (0 for one never launched)."""
    return {name: lib.entry_launches.get(name, 0)
            for lib in _libraries() for name in lib.signatures if not name.endswith("_info")}


def count_launches(fn: Callable, *args: Any, **kwargs: Any) -> Tuple[Any, Dict[str, int]]:
    """(fn(*args, **kwargs), {kernel entry: launches the call made on this
    rank}); entries it did not launch are left out."""
    before = launch_counts()
    out = fn(*args, **kwargs)
    after = launch_counts()
    return out, {k: n - before[k] for k, n in after.items() if n != before[k]}
