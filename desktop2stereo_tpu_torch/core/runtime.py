"""Device policy for the port: one CUDA device, bf16 compute, TF32 stated.

The JAX package picks a platform and a mesh; the port runs on one NVIDIA
GPU and has no CPU fallback for its measured path.  The CPU is only where
the tests run the plain-PyTorch versions of the kernels.

TF32: a float32 matmul on the card runs in full float32 by default, but a
float32 cuDNN convolution runs in TF32 (about three decimal digits).  The
policy sets both flags explicitly; they are False for parity phases, and
the flagship path computes in bf16 anyway.

Several ranks: `make_mesh` builds the port's counterpart of the JAX
package's ("data", "model") mesh (`desktop2stereo_tpu/core/runtime.py:
make_mesh`) over `torch.distributed`, one process a shard; see
`desktop2stereo_tpu_torch/parallel/`.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch

COMPUTE_DTYPE = torch.bfloat16

# the mesh's axis names, the JAX package's own (a copy: the port imports
# nothing of it)
DATA_AXIS = "data"
MODEL_AXIS = "model"
# every process group's collective timeout: a rank whose peer died fails in
# this time instead of waiting without end
GROUP_TIMEOUT_S = 60.0


@dataclass(frozen=True)
class DevicePolicy:
    device: torch.device
    compute_dtype: torch.dtype
    allow_tf32: bool
    name: str


def set_tf32(enabled: bool) -> None:
    """Set both TF32 switches (cuBLAS matmul and cuDNN convolution)."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def cuda_policy(index: int = 0, allow_tf32: bool = False) -> DevicePolicy:
    """The policy for CUDA device `index`; raises if CUDA is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "desktop2stereo_tpu_torch needs a CUDA device: "
            "torch.cuda.is_available() is False")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present")
    set_tf32(allow_tf32)
    return DevicePolicy(
        device=torch.device("cuda", index),
        compute_dtype=COMPUTE_DTYPE,
        allow_tf32=allow_tf32,
        name=torch.cuda.get_device_name(index),
    )


class F32Module(torch.nn.Module):
    """A module that computes in float32 whatever the model's dtype: its
    floating parameters and buffers follow `Module.to` / `.cuda()` to the
    new device but keep float32 (ZoeDepth's metric-bins head, InfiniDepth's
    conv stem: the JAX modules promote them to f32 under a bf16 trunk)."""

    def _apply(self, fn, recurse=True):
        def keep(t: torch.Tensor) -> torch.Tensor:
            if not t.is_floating_point():
                return fn(t)
            # fn's target device, probed from t's own: a dtype-only cast
            # (`.to(torch.bfloat16)`, `.half()`) leaves t where it is
            return t.to(fn(t.new_zeros(())).device)

        return super()._apply(keep, recurse)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a `num_data` × `num_model` grid of processes:
    global rank `data_index · num_model + model_index`, as the JAX mesh
    lays devices out.  `model_group` holds the ranks of this rank's data
    index (the tensor-parallel shards of one model), `data_group` those of
    its model index (the replicas that split a batch)."""

    num_data: int
    num_model: int
    rank: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    device: torch.device
    backend: str


def mesh_device(device: Optional[torch.device | str], world_size: int, rank: int
                ) -> tuple[torch.device, str]:
    """(this rank's device, the backend) for `device` ("cuda" when None):
    each rank its own card and NCCL where there are at least `world_size`
    cards and no card index was given; every rank on the named card (card 0
    for a bare "cuda" with too few cards) and gloo otherwise; gloo on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev, "gloo"
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: a mesh runs on cuda or cpu, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA requested and torch.cuda.is_available() is False; "
                           "pass device='cpu' for a CPU mesh")
    if dev.index is None and torch.cuda.device_count() >= world_size:
        return torch.device("cuda", rank), "nccl"
    return torch.device("cuda", dev.index or 0), "gloo"


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device: Optional[torch.device | str] = None, backend: Optional[str] = None,
              *, rank: Optional[int] = None, world_size: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """This rank's `Mesh` over `num_data` × `num_model` processes.

    Called in every rank.  Starts the default process group where none is
    running: `rank`, `world_size` and `init_method` default to torchrun's
    RANK, WORLD_SIZE and `env://`.  `num_data` None takes every rank:
    world_size // num_model.  The backend is chosen once, before anything
    starts (`mesh_device`; `backend` overrides it) and printed with the world
    size; a failure raises and nothing is retried on another backend.  Every
    rank builds every data and model group, in one order, as
    `torch.distributed.new_group` requires."""
    import torch.distributed as dist

    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if num_data is None:
        num_data = world_size // num_model
    if num_data < 1 or num_model < 1 or num_data * num_model != world_size:
        raise ValueError(f"mesh {num_data}x{num_model} does not cover the {world_size} ranks")
    dev, chosen = mesh_device(device, world_size, rank)
    backend = backend or chosen
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    backend = dist.get_backend()
    if rank == 0:
        print(f"[mesh] {num_data}x{num_model} ({DATA_AXIS} x {MODEL_AXIS}): backend {backend}, "
              f"world size {world_size}, {dev.type}"
              + (f" ({'one card a rank' if backend == 'nccl' else f'every rank on card {dev.index}'})"
                 if dev.type == "cuda" else ""), flush=True)
    d, m = divmod(rank, num_model)
    data_group = model_group = None
    for i in range(num_model):       # the data groups: one model index each
        g = dist.new_group([j * num_model + i for j in range(num_data)])
        if i == m:
            data_group = g
    for j in range(num_data):        # the model groups: one data index each
        g = dist.new_group([j * num_model + i for i in range(num_model)])
        if j == d:
            model_group = g
    return Mesh(num_data, num_model, rank, d, m, data_group, model_group, dev, backend)
