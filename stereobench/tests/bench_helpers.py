"""Helpers of the benchmark's tests: a copy of the benchmark with tiny
cells added as new files and entries, and the card fixture."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

TINY_DA2 = dict(model="Depth-Anything-V2-Small", hidden_size=384, num_attention_heads=6,
                num_hidden_layers=12, intermediate_size=1536, out_indices=[2, 5, 8, 11],
                neck_hidden_sizes=[48, 96, 192, 384], fusion_hidden_size=64,
                depth_resolution=56)
TINY_MIX = dict(engine="batched", feeds=2, frame=[64, 112, 4], capture_hz=60,
                generator="desktop", ring=3, lead_in_s=0.5, trace_slice_s=1.0, check_frames=6)
# the tiny cells' limits, set as the real cells' are, from CPU readings
# (the batched and the one-feed cell, twelve program seeds each, three of
# each control and fault): encoder_error_ratio 0.71-1.40 for the bfloat16
# program, 3.79-5.04 for its int8 encoder and 6.4-7.8 for the reference in
# fp8; decoder_error_ratio.folded 0.92-1.24, and 11.9-18.0 in fp8;
# depth_post_abs.worst at most 1.9e-9, and 0.0045-0.14 with the EMA state
# left unchanged or half the batch replaced; sbs_off_share.worst 0, and
# 0.125 with an altered answer.
TINY_LIMITS = {"encoder_error_ratio": 2.4, "decoder_error_ratio.folded": 4.0,
               "depth_post_abs.worst": 1e-5, "sbs_off_share.worst": 0.01}


def config(name: str) -> dict:
    """A configuration file of `configs/` by its name."""
    with open(ROOT / "stereobench" / "configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.fixture
def cuda():
    """Skips a test on a host without a CUDA device (decided here, when the
    test runs, never while a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_copy(tmp: Path, metric_src: str | None = None) -> Path:
    """A copy of BENCHMARK.json and stereobench/ in `tmp` with a tiny
    configuration, two tiny mixes (batched over 2 feeds, and one feed), their
    cells and limits added as new files and entries, and, given its source,
    a made-up per-layer metric `extra.rows_per_step` read in both cells."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "stereobench", tmp / "stereobench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    cfg = dict(config("da2-large-518"), **TINY_DA2)
    (tmp / "stereobench" / "configs" / "tiny-da2.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-da2", "source": "https://example.org/tiny",
                             "file": "stereobench/configs/tiny-da2.json", "reduced": [],
                             "why": "a tiny configuration for the CPU tests"})
    for mix, engine, feeds in (("tiny-batched", "batched", 2), ("tiny-single", "single", 1)):
        (tmp / "stereobench" / "traffic" / f"{mix}.json").write_text(
            json.dumps(dict(TINY_MIX, engine=engine, feeds=feeds)))
        bench["workloads"].append({"name": mix, "config": "tiny-da2", "traffic": mix,
                                   "chips": 1, "why": "tiny"})
        (tmp / "stereobench" / "limits" / f"{mix}.json").write_text(json.dumps(TINY_LIMITS))
    for m in bench["per_layer"]:
        m["workloads"] += ["tiny-batched", "tiny-single"]
    if metric_src is not None:
        (tmp / "stereobench" / "metrics" / "extra.rows_per_step.py").write_text(metric_src)
        bench["per_layer"].append({"name": "extra.rows_per_step", "unit": "rows",
                                   "better": "higher", "source": "program_counter",
                                   "layer": "engine", "moves": "frames_per_s",
                                   "workloads": ["tiny-batched", "tiny-single"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
