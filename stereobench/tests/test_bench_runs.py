"""Whole runs of the harness on the CPU at a tiny size, with everything but
the look for a card: a cell made of new files and entries alone, and the
check seeing `correct` come out false when the timed path is broken
underneath it."""

import time

import pytest
import torch

from stereobench import harness, manifest
from stereobench.run import verdict
from stereobench.tests.bench_helpers import tiny_copy


EXTRA_METRIC = '''"""Rows a program call held, over the window's calls (a made-up metric)."""


def read(run):
    rows = [len(st.rows) for st in run.steps if run.window[0] <= st.t_dispatch < run.window[1]]
    return sum(rows) / len(rows) if rows else None
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"), EXTRA_METRIC)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(root, cell, traced=False, seed=7, control="none"):
    c = manifest.load_cell(cell, root)
    out = harness.run_cell(c, seed, 1.5, traced, torch.device("cpu"), time.perf_counter(),
                           control=control)
    return verdict(c, out)[0], out


@pytest.mark.parametrize("cell", ["tiny-batched", "tiny-single"])
def test_a_cell_added_as_files_runs_and_is_correct(root, cell):
    result, out = run(root, cell)
    assert out["error"] is None and result["correct"], result["check"]
    assert set(result["metrics"]) == {"frames_per_s", "latency_p50_ms", "latency_p95_ms",
                                      "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert out["sampled"] == 6
    assert list(result)[-1] == "check"


def test_the_made_up_metric_is_read_in_a_traced_run(root):
    result, _ = run(root, "tiny-batched", traced=True)
    assert result["metrics"]["extra.rows_per_step"]["value"] == 2.0
    assert result["metrics"]["extra.rows_per_step"]["unit"] == "rows"
    # no device on the CPU: the device's readers find nothing and stay silent
    assert "device.idle" not in result["metrics"] and "kernel.k2_roofline" not in result["metrics"]
    assert "engine.dispatch_ms" in result["metrics"]


@pytest.mark.parametrize("cell", ["tiny-batched", "tiny-single"])
def test_the_control_is_not_correct(root, cell):
    """The controls, a step below the configuration's bfloat16: the
    program's own int8 encoder, and the reference computed in fp8 in the
    program's model stage."""
    for control in ("int8", "fp8-reference"):
        for seed in (1, 2, 3):
            result, out = run(root, cell, seed=seed, control=control)
            assert out["error"] is None and out["sampled"] > 0
            assert not result["correct"], (control, seed, result["check"])


FAULTS = [("state_unchanged", "tiny-batched"), ("state_unchanged", "tiny-single"),
          ("half_batch", "tiny-batched"), ("answer_altered", "tiny-batched"),
          ("answer_altered", "tiny-single")]


@pytest.mark.parametrize("fault,cell", FAULTS)
def test_a_broken_timed_path_is_not_correct(root, fault, cell):
    """Each fault of `faults.py` the cell can have, planted under the
    harness: the stage it breaks reads over its limit."""
    result, out = run(root, cell, control=fault.replace("_", "-"))
    assert out["error"] is None and out["sampled"] > 0
    assert not result["correct"], result["check"]

