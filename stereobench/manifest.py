"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
harness reads `configs/<config>.json` through the configuration's `file`,
`traffic/<mix>.json`, `limits/<cell>.json` (the limit of each number
`correct` compares), `reference/<family>.py` (the configuration's
`family`), and `metrics/<metric>.py` for each metric the cell reports.
Adding a configuration, a mix, a metric or a cell adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    bench_dir = root / "stereobench"
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    with open(bench_dir / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], root)


def _load(path: Path, prefix: str, name: str):
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    spec = importlib.util.spec_from_file_location(f"{prefix}{re.sub(r'\W', '_', name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(config: dict, root: Path = ROOT):
    """The configuration's reference module, `reference/<family>.py`."""
    name = config["family"]
    return _load(root / "stereobench" / "reference" / f"{name}.py", "stereobench_family_", name)


def metric_reader(name: str, root: Path = ROOT):
    """`metrics/<name>.py`'s `read(run) -> Optional[float]`."""
    return _load(root / "stereobench" / "metrics" / f"{name}.py", "stereobench_metric_",
                 name).read


def read_metrics(metrics: List[dict], run, root: Path = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found something."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
