"""Run a function on every rank of a (data, model) mesh, one process a rank.

The JAX package runs its mesh in one process (GSPMD over the host's
devices); the port runs one process a shard over `torch.distributed`, and
one process cannot hold a multi-process mesh, so a caller that is not
started by torchrun spawns the ranks with `spawn`.

Each rank is a fresh interpreter (the `spawn` start method: no state of the
parent, JAX's included, comes along) with one torch intra-op thread.  The
ranks meet through a `file://` store in a temporary directory, not a fixed
port, so that several groups can start side by side; every process group
has `GROUP_TIMEOUT_S` to finish a collective.  The parent waits on the
ranks with a deadline: a rank that raises, or dies, makes the parent kill
the others and raise with that rank's traceback at once.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

DEFAULT_DEADLINE_S = 600.0


class RankFailed(RuntimeError):
    """A rank raised, died or outlived the deadline; the message holds its
    traceback or exit code."""


def _rank_main(fn: Callable, rank: int, num_data: int, num_model: int, device: Optional[str],
               backend: Optional[str], init_method: str, results, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    from desktop2stereo_tpu_torch.core.runtime import make_mesh
    from desktop2stereo_tpu_torch.parallel.sharding import ParallelContext

    torch.set_num_threads(1)
    try:
        mesh = make_mesh(num_data, num_model, device, backend, rank=rank,
                         world_size=num_data * num_model, init_method=init_method)
        out = fn(ParallelContext(mesh), *args)
        results.put((rank, "ok", out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, "error", traceback.format_exc()))
        return
    dist.destroy_process_group()


def spawn(fn: Callable, num_data: int, num_model: int, device: Optional[str] = "cuda",
          *args: Any, backend: Optional[str] = None,
          deadline_s: float = DEFAULT_DEADLINE_S) -> Any:
    """`fn(ctx, *args)` on each of `num_data · num_model` new processes,
    `ctx` the rank's `ParallelContext`; → rank 0's return value.  `fn`, its
    arguments and rank 0's result must pickle (module-level functions,
    tensors, numpy arrays).  `device` "cuda" (the default: one card a rank
    and NCCL where there are enough cards, else every rank on card 0 over
    gloo; see `core/runtime.py:mesh_device`), "cuda:<i>" or "cpu".  Raises
    RankFailed when a rank raises or dies, or when `deadline_s` passes,
    having killed every rank."""
    world = num_data * num_model
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="d2s_mesh_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, name=f"d2s-rank-{r}",
                         args=(fn, r, num_data, num_model, device, backend, init_method,
                               results, args), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        done, out = set(), None
        end = time.monotonic() + deadline_s
        while len(done) < world:
            try:
                rank, status, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RankFailed(f"rank {procs.index(dead[0])} died with exit code "
                                     f"{dead[0].exitcode} before reporting")
                if time.monotonic() > end:
                    raise RankFailed(f"ranks {sorted(set(range(world)) - done)} did not "
                                     f"finish within {deadline_s:.0f} s")
                continue
            if status == "error":
                # a peer that died is the likelier cause: name it
                settle = time.monotonic() + 1.0
                for p in procs:
                    p.join(timeout=max(0.0, settle - time.monotonic()))
                dead = "".join(f" (rank {r} died with exit code {p.exitcode})"
                               for r, p in enumerate(procs) if p.exitcode not in (None, 0))
                raise RankFailed(f"rank {rank} raised{dead}:\n{value}")
            done.add(rank)
            if rank == 0:
                out = value
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
