"""Device policy for the port: one CUDA device, bf16 compute, TF32 stated.

The JAX package picks a platform and a mesh; the port runs on one NVIDIA
GPU and has no CPU fallback for its measured path.  The CPU is only where
the tests run the plain-PyTorch versions of the kernels.

TF32: a float32 matmul on the card runs in full float32 by default, but a
float32 cuDNN convolution runs in TF32 (about three decimal digits).  The
policy sets both flags explicitly; they are False for parity phases, and
the flagship path computes in bf16 anyway.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

COMPUTE_DTYPE = torch.bfloat16


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
