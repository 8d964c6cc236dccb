"""Build and warm ahead of a run: the kernels built, every stage primed.

Port of `desktop2stereo_tpu/tools/aot_compile.py`.  The JAX tool fills the
persistent XLA cache so that a production run's first frame is served at
steady-state latency (the reference builds its fixed-shape engines lazily
on the first frame, reference depth.py:1841-1862).  The port has no
compiled programs to cache; what a first frame pays for here is the nvcc
build of the five kernel sources (the libraries persist under
`desktop2stereo_tpu_torch/_build/`, keyed by a hash of each source) and
the first call of every stage (cuDNN and cuBLAS plan selection, the resize
tables).  This tool builds the five sources in parallel, then runs
`ProgramCache.warmup` for each capture shape, and prints the seconds of
each step:

    python -m desktop2stereo_tpu_torch.tools.aot_compile \\
        --model Depth-Anything-V2-Large --depth-res 518 \\
        --shapes 2160x3840,1080x1920 --output-resolution 2160

`--device cpu` warms the plain-PyTorch path on the CPU and builds nothing.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="Depth-Anything-V2-Small")
    ap.add_argument("--depth-res", type=int, default=None,
                    help="model input resolution (default: registry default)")
    ap.add_argument("--shapes", default="1080x1920",
                    help="comma-separated capture HxW list")
    ap.add_argument("--output-resolution", type=int, default=1080)
    ap.add_argument("--display-mode", default="Half-SBS")
    ap.add_argument("--quality", choices=("high", "fast"), default="high")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--quant", default="none", choices=["none", "int8"],
                    help="warm the int8 encoder variant")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda' (default): build the kernels and warm on CUDA "
                         "device 0; 'cpu': warm the plain-PyTorch path")
    args = ap.parse_args(argv)

    import torch

    from desktop2stereo_tpu_torch.core.config import Settings
    from desktop2stereo_tpu_torch.core.registry import effective_compute_dtype, get_spec
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.ops.kernels.build import build_all
    from desktop2stereo_tpu_torch.pipeline.programs import ProgramCache, ProgramConfig

    if args.device == "cpu":
        device, dtype = torch.device("cpu"), torch.float32
        print("[aot] device: cpu (plain-PyTorch kernels), nothing to build")
    else:
        policy = cuda_policy(0)
        device = policy.device
        dtype = torch.float32 if args.fp32 else policy.compute_dtype
        t0 = time.perf_counter()
        built = build_all()
        print("[aot] kernels: " + ", ".join(
            f"{name} {'already built' if s is None else f'nvcc {s:.1f}s'}"
            for name, s in built.items())
            + f"; all built and loaded in {time.perf_counter() - t0:.1f}s (in parallel)")
    spec = get_spec(args.model)
    compute = effective_compute_dtype(spec, dtype)
    print(f"[aot] device: {device}, dtype: {compute}")

    t0 = time.perf_counter()
    model, spec = build_bound(args.model, device=device, dtype=compute, quant=args.quant,
                              checkpoint=args.checkpoint)
    print(f"[aot] {args.model} built in {time.perf_counter() - t0:.1f}s")
    settings = Settings(
        model=args.model,
        depth_resolution=args.depth_res or (spec.resolutions or (384,))[0],
        output_resolution=args.output_resolution,
        display_mode=args.display_mode,
    )
    cfg = ProgramConfig.from_settings(settings, quality=args.quality)
    cache = ProgramCache(cfg, model, spec, compute_dtype=compute)

    for shape in args.shapes.split(","):
        h, w = (int(v) for v in shape.lower().split("x"))
        t0 = time.perf_counter()
        rep = cache.warmup((h, w, 4))
        stages = ", ".join(f"{k[:-2]} {v:.2f}s" for k, v in rep.items())
        print(f"[aot] {h}x{w}: warm in {time.perf_counter() - t0:.1f}s ({stages})")
    print("[aot] done: the kernels are built and every stage has run once")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
