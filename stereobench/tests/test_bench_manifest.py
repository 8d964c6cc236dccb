"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from stereobench import manifest
from stereobench.tests.bench_helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(_text_ok(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in bench["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names)
    for group in (bench["configs"], bench["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_config_has_a_cell_and_a_file(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert 1 <= len(bench["configs"]) <= 24
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert (ROOT / c["file"]).is_file()


def test_cells(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(pairs) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
        cell = manifest.load_cell(w["name"], ROOT)
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
        assert (ROOT / "stereobench" / "reference" / f"{cell.config['family']}.py").is_file()


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _text_ok(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer
    for cell in cells:
        reported = [m for m in bench["end_to_end"] if "workloads" not in m
                    or cell in m["workloads"]]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in bench["per_layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.metric_reader(m["name"], ROOT))
    roofs = [m for m in bench["per_layer"] if m["name"].endswith("_roofline")]
    assert all(m["unit"] == "%" for m in roofs)
    assert any("mfu" in m["name"] for m in bench["per_layer"])
