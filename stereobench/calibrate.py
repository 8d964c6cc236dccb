"""The readings the check's limits are set from: the numbers `correct`
compares, for the program and for its control, over many seeds in one
process (the benchmark's own runs never run this).

    python stereobench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 6 \\
        [--control none,int8,fp8-reference,state-unchanged,half-batch,answer-altered,
                   carry-frozen,carry-reset] \\
        [--out FILE]

Each seed of each control named is one run of the cell at its own load (`harness.run_cell`) with
a short window.  The controls compute in the precision below the bfloat16
the configurations state: `int8`, the program with its int8 encoder
switched on (`--quant int8` of the CLI); `fp8-reference`, the plain
reference computed in fp8 in the program's model stage (`control.py`).
The faults of `faults.py` are planted in the program (`carry-frozen` and
`carry-reset` only mean something for a stateful model).  Prints one JSON line
a run, with every number the check computed and the verdict of the
benchmark's own comparison (`run.verdict`: `correct` and each compared
number with its limit), and appends each to FILE as it comes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--control", default="none",
                   help="comma-separated: none (the program); int8, the program with its "
                        "int8 encoder; fp8-reference, the reference computed in fp8 in the "
                        "program's model stage; a fault of faults.py (state-unchanged, "
                        "half-batch, answer-altered, carry-frozen, carry-reset)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from stereobench.run import cache_env

    cache_env()
    import torch

    from stereobench import manifest
    from stereobench.harness import run_cell
    from stereobench.run import verdict

    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA device", file=sys.stderr)
        return 2
    from stereobench.faults import FAULTS

    controls = args.control.split(",")
    unknown = set(controls) - {"none", "int8", "fp8-reference", *FAULTS}
    if unknown:
        p.error(f"unknown control(s): {', '.join(sorted(unknown))}")
    cell = manifest.load_cell(args.workload, ROOT)
    for control, seed in ((c, int(s)) for c in controls for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "control": control}
        try:
            out = run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t,
                           control=control)
            result, _ = verdict(cell, out)
        except Exception as e:  # a control that crashes has failed; the next seed runs
            traceback.print_exc()
            row.update(correct=False, error=f"{type(e).__name__}: {e}")
        else:
            row.update(correct=result["correct"], check=result["check"],
                       numbers=out["numbers"], error=out["error"],
                       check_error=out["check_error"], steps=out["steps"],
                       sampled=out["sampled"], delivered=out["delivered"],
                       metrics=result["metrics"])
        row["run_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
