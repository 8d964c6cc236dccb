#!/usr/bin/env python3
"""Time two versions of the port's attention (K2) and int8 dense (K4)
kernel sources side by side on one NVIDIA GPU.

    python3 kernel_ab.py OTHER_CSRC     # from the repository root

OTHER_CSRC is a directory holding another version's `attention.cu` and
`quant_matmul.cu` (and any header they include), for example a
`git show <commit>:desktop2stereo_tpu_torch/csrc/<name>` of an earlier
commit.  Both versions are built with nvcc at first use, checked against
each other (K4 exactly, K2 within 2e-2), and timed in turns, each callable
device-only (10 calls captured into a CUDA graph) and eager, with SDPA and
`torch._int_mm` beside them, at the DA-V2-Large shapes of `chip_smoke.py`.
The other `attention.cu` has the same C interface as this one; its
`quant_matmul.cu` may take the row pass's scratch pointers (xq, xs) as this
one does, or not, as the source's `d2s_quant_dense` declares.  Prints one
JSON object last and writes chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv) -> int:
    if len(argv) != 2 or not (Path(argv[1]) / "quant_matmul.cu").is_file():
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
    from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary

    other = Path(argv[1]).resolve()
    policy = cuda_policy(0, allow_tf32=False)
    dev = policy.device
    card = cs.card_line()
    print(card, flush=True)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    k4_src = (other / "quant_matmul.cu").read_text()
    scratch = "void* xq" in k4_src
    k4_sig = [_P, _I, _I, _P, _P, _P, _P] + ([_P, _P] if scratch else []) + [_P, _I, _I, _I, _I, _P]
    other_k2 = CudaLibrary(str(other / "attention.cu"), K2.KERNEL.signatures)
    other_k4 = CudaLibrary(str(other / "quant_matmul.cu"), {"d2s_quant_dense": k4_sig})

    def other_attention(q, k, v):
        saved, K2.KERNEL = K2.KERNEL, other_k2
        try:
            return K2.attention(q, k, v)
        finally:
            K2.KERNEL = saved

    def other_dense(x, wq, scale, bias):
        M, K = x.shape
        out = torch.empty((M, wq.shape[0]), dtype=x.dtype, device=dev)
        held = ([torch.empty((M, K), dtype=torch.int8, device=dev),
                 torch.empty((M,), dtype=torch.float32, device=dev)] if scratch else [])
        extra = [t.data_ptr() for t in held]
        other_k4.call("d2s_quant_dense", x.data_ptr(), int(x.dtype == torch.bfloat16),
                      x.stride(0), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(), None,
                      *extra, out.data_ptr(), 1 if x.dtype == torch.bfloat16 else 0, M, K,
                      wq.shape[0], torch.cuda.current_stream(dev).cuda_stream)
        return out

    result = {"card": card, "other": str(other), "rows": {}}
    B, N, H, D = cs.ATTN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    err = (K2.attention(q, k, v).float() - other_attention(q, k, v).float()).abs().max().item()
    if err > cs.ATTN_MAX_ABS:
        raise AssertionError(f"attention: the two versions differ by {err}")
    t = cs.time_both(torch, {"this": lambda: K2.attention(q, k, v),
                             "other": lambda: other_attention(q, k, v),
                             "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)})
    result["rows"]["attention"] = dict(t, shape=f"{list(cs.ATTN_SHAPE)} bf16 qkv views",
                                       max_abs_between=err)
    for name, kin, fout in cs.VIT_L_DENSE:
        x, wq, scale, bias = cs.dense_inputs(np, torch, dev, N, kin, fout, torch.bfloat16,
                                             True, seed=kin + fout)
        if not torch.equal(K4.quant_dense(x, wq, scale, bias), other_dense(x, wq, scale, bias)):
            raise AssertionError(f"quant_matmul {name}: the two versions differ")
        xq8 = x.float().clamp(-127, 127).round().to(torch.int8)
        wt = wq.t()
        t = cs.time_both(torch, {"this": lambda: K4.quant_dense(x, wq, scale, bias),
                                 "other": lambda: other_dense(x, wq, scale, bias),
                                 "library": lambda: torch._int_mm(xq8, wt)})
        result["rows"][f"quant_matmul_{name}"] = dict(
            t, shape=f"{name} [{N},{kin}] bf16 x [{fout},{kin}] int8 + bias")
    for name, row in result["rows"].items():
        e = row["eager"]
        print(f"[ab] {name} {row['shape']}: this {row['this']:.4f} ms (eager {e['this']:.4f}), "
              f"other {row['other']:.4f} (eager {e['other']:.4f}), library "
              f"{row['library']:.4f} (eager {e['library']:.4f}); device-only = CUDA graphs of "
              f"10 calls, median of {cs.TIMED_RUNS}; {card}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
