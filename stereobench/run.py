"""Run one cell of the benchmark once and print its result line.

    python stereobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program
(`desktop2stereo_tpu_torch/`) beside `BENCHMARK.json` and `stereobench/`.
Needs as many CUDA devices as the cell asks for, and exits 2 without a
result otherwise.  The last line of standard output is the result (JSON);
the last lines of standard error give each number the check compared, with
its limit.  `--trace 0` reports the cell's end-to-end metrics, `--trace 1`
its per-layer metrics from a profiled slice of the window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "stereobench"
FORBIDDEN = ("jax", "jaxlib", "flax", "desktop2stereo_tpu")


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = BENCH / "_cache"
    os.environ["D2S_BUILD_DIR"] = str(cache / "build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (the part before the first dot, compared whole)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache_env()
    from stereobench.harness import process_start, run_cell

    t_process = process_start()
    import torch

    from stereobench import manifest

    cell = manifest.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); {n} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_process)

    bad = forbidden_modules()
    if bad:
        print(f"[bench] loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    result, checks = verdict(cell, out)
    print(f"[bench] {args.workload} seed {args.seed}: {out['delivered']} frames delivered, "
          f"{out['superseded']} captures superseded (latest wins), {out['sampled']} checked; "
          f"program calls {json.dumps(out['steps'])}; check {out['check_s']:.1f} s")
    if out["error"]:
        print(f"[bench] engine error: {out['error']}")
    if out["check_error"]:
        print(f"[bench] check: {out['check_error']}")
    for line in out["malformed"][:10]:
        print(f"[bench] malformed frame: {line}")
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0 if out["error"] is None else 1


def verdict(cell, out: dict):
    """(the result line's object, the check's numbers with their limits)."""
    numbers = out["numbers"] or {}
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    correct = (out["error"] is None and out["check_error"] is None and not out["malformed"]
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    return {"correct": bool(correct), **out["result"], "check": checks}, checks

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
