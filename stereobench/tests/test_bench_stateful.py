"""The harness on a model that carries state between frames: tiny
Video-Depth-Anything cells added as files and entries to a copy of the
benchmark, run whole on the CPU; the check seeing `correct` come out false
for the controls and the faults a stateful cell can have; a stale row's
carry; and the temporal modules' count."""

import json
import time

import numpy as np
import pytest
import torch

from stereobench import harness, manifest, record, roofline, traffic, weights
from stereobench.run import verdict
from stereobench.tests.bench_helpers import TINY_MIX, config, tiny_copy

# Video-Depth-Anything-Small's widths (the program builds the registry's):
# temporal modules on 192, 384, 64 and 64 channels
TINY_VDA = dict(model="Video-Depth-Anything-Small", hidden_size=384, num_attention_heads=6,
                num_hidden_layers=12, intermediate_size=1536, out_indices=[2, 5, 8, 11],
                neck_hidden_sizes=[48, 96, 192, 384], fusion_hidden_size=64,
                depth_resolution=56)
# limits as the tiny DA cells' (`bench_helpers.TINY_LIMITS`), with the
# carry's, set from CPU readings of the two cells below (seeds 1-12 of the
# program, 1-3 of each control and fault): carry_error_ratio 0.896-1.047
# for the program and 11.3-13.7 for the reference in fp8 (0.87-1.08 for the
# int8 encoder and every fault), so 3.5, near their geometric mean;
# carry_shift_off 0 for the program (the update is a copy), 0.027-0.031
# with the carry frozen and 1 with the state left unchanged (the program
# then holds no carry), so 0; carry_in_off, exact as well, 0 for the
# program and 1 with every call started as a first call, so 0;
# decoder_error_ratio.folded 0.86-1.31, and 10.4-15.8 in fp8.
TINY_VDA_LIMITS = {"encoder_error_ratio": 2.4, "decoder_error_ratio.folded": 4.0,
                   "carry_error_ratio": 3.5, "carry_shift_off": 0.0, "carry_in_off": 0.0,
                   "depth_post_abs.worst": 1e-5, "sbs_off_share.worst": 0.01}
CELLS = ("tiny-vda-batched", "tiny-vda-single")


def vda_copy(tmp):
    """`tiny_copy`, with a tiny Video-Depth-Anything configuration and a
    batched (2 feeds) and a one-feed cell on it."""
    root = tiny_copy(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = dict(config("vda-large-518"), **TINY_VDA)
    (root / "stereobench" / "configs" / "tiny-vda.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-vda", "source": "https://example.org/tiny",
                             "file": "stereobench/configs/tiny-vda.json", "reduced": [],
                             "why": "a tiny stateful configuration for the CPU tests"})
    for cell, engine, feeds in zip(CELLS, ("batched", "single"), (2, 1)):
        (root / "stereobench" / "traffic" / f"{cell}.json").write_text(
            json.dumps(dict(TINY_MIX, engine=engine, feeds=feeds)))
        bench["workloads"].append({"name": cell, "config": "tiny-vda", "traffic": cell,
                                   "chips": 1, "why": "tiny"})
        (root / "stereobench" / "limits" / f"{cell}.json").write_text(json.dumps(TINY_VDA_LIMITS))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return vda_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(root, cell, seed=7, control="none"):
    c = manifest.load_cell(cell, root)
    out = harness.run_cell(c, seed, 1.5, False, torch.device("cpu"), time.perf_counter(),
                           control=control)
    return verdict(c, out)[0], out


@pytest.mark.parametrize("cell", CELLS)
def test_a_stateful_cell_runs_and_is_correct(root, cell):
    result, out = run(root, cell)
    assert out["error"] is None and result["correct"], result["check"]
    assert out["sampled"] == 6 and result["attempted"] > 0 and result["failed"] == 0
    numbers = out["numbers"]
    assert numbers["carry_shift_off"] == 0.0 and numbers["carry_in_off"] == 0.0
    assert 0 < numbers["carry_error_ratio"] < TINY_VDA_LIMITS["carry_error_ratio"]


BROKEN = [(c, cell) for c in ("carry-frozen", "carry-reset", "state-unchanged",
                              "answer-altered", "fp8-reference") for cell in CELLS]
ONLY = {"carry-frozen": ["carry_shift_off"], "carry-reset": ["carry_in_off"]}


@pytest.mark.parametrize("control,cell", BROKEN)
def test_a_control_or_a_fault_is_not_correct(root, control, cell):
    """The fp8 reference in the model stage (first and step, the same
    carry) and each fault a stateful cell can have, planted under the
    harness: a stage reads over its limit.  A frozen carry reads only in
    `carry_shift_off`, a carry reset every call only in `carry_in_off`."""
    result, out = run(root, cell, seed=3, control=control)
    assert out["error"] is None and out["sampled"] > 0
    assert not result["correct"], result["check"]
    if control in ONLY:
        over = [k for k, c in result["check"].items() if c["value"] > c["limit"]]
        assert over == ONLY[control], result["check"]


def _recorded(carries, rows=2):
    """A `record.Recorder` of VDA's `advance`, after one batched call for
    each carry in `carries` (None: a first call), each with entries drawn
    from one seed and the carry out advanced from them."""
    fam = manifest.family(config("vda-large-518"))
    g = torch.Generator().manual_seed(4)
    rec = record.Recorder([[np.zeros((2, 2, 4), np.uint8)]] * rows, None, batched=True,
                          advance=fam.advance)
    for k, carry_in in enumerate(carries):
        entries = [torch.randn(rows, 3, 1, 5, generator=g) for _ in range(2)]
        rec.staged(0.0, [(f, 0, float(k)) for f in range(rows)])
        rec.dispatched(float(k), 0.0, None, {
            "enc": {}, "raw": torch.zeros(rows, 1, 1), "depth": torch.zeros(rows, 1, 1),
            "carry_in": carry_in, "entries": entries,
            "carry_out": fam.advance(carry_in, entries)})
    return rec


@pytest.mark.parametrize("given", ["held", "none", "other-row", "first-with-one"])
def test_the_carry_in_is_the_rows_previous_carry_out(given):
    """`carry_in_off` counts, at the sampled row, the carry in that is not
    the carry out of the row's previous call as the program held it: a
    later call given none (every call a first call) or another row's, or a
    first call given one, is off in every value; the held one reads 0."""
    held = _recorded([None]).stages[0]["carry_out"]  # as the call below's first holds it
    carry = {"held": held, "none": None, "other-row": tuple(c.flip(0) for c in held),
             "first-with-one": held}[given]
    rec = _recorded([carry] if given == "first-with-one" else [None, carry])
    k = len(rec.steps) - 1
    st = rec._stages_of(1, float(k))
    (off, values), (shift_off, _) = st["chain"], st["shift"]
    assert values == 2 * 31 * 3 * 5 and int(shift_off) == 0
    assert int(off) == (0 if given == "held" else values)


def test_a_stale_row_keeps_its_carry_bit_for_bit(root):
    """A batched step with one row not fresh: the tap's carry out holds that
    row as it came in, and the fresh row advanced by the reference's
    protocol from the program's entries."""
    cell = manifest.load_cell("tiny-vda-batched", root)
    fam = manifest.family(cell.config, root)
    device = torch.device("cpu")
    with torch.device("meta"):
        shapes = fam.build(cell.config)
    state = weights.draw(shapes, cell.config["init"], 5, device, torch.float32)
    program, model, root_module = harness.build_program(cell, state, device, torch.float32)
    tap = record.StageTap(model, root_module, cell.config["check_encoders"])
    rings = traffic.feed_rings(cell.mix, 5)
    timed = record.TimedProgram(program, record.Recorder(rings, None, batched=True), tap)
    calls = []

    def step(k, fresh):
        timed.recorder.staged(0.0, [(f, k % len(rings[f]), float(k)) for f in range(2)])
        timed(np.stack([rings[f][k % len(rings[f])] for f in range(2)]), fresh=fresh)
        calls.append(timed.recorder.stages[len(timed.recorder.steps) - 1])

    for k, fresh in enumerate([None, [True, True], [True, False], [False, True]]):
        step(k, fresh)
    tap.remove()
    first, _, one_stale, other_stale = calls
    assert first["carry_in"] is None
    for st, stale in ((one_stale, 1), (other_stale, 0)):
        fresh_row = 1 - stale
        for c_in, c_out in zip(st["carry_in"], st["carry_out"]):
            assert torch.equal(c_out[stale], c_in[stale])
        want = fam.advance(tuple(c[fresh_row:fresh_row + 1] for c in st["carry_in"]),
                           [e[fresh_row:fresh_row + 1] for e in st["entries"]])
        for w, got in zip(want, st["carry_out"]):
            assert torch.equal(got[fresh_row:fresh_row + 1], w)
    # the carry out of one call is the next call's carry in, as the program holds it
    for a, b in zip(calls, calls[1:]):
        assert all(x is y for x, y in zip(a["carry_out"], b["carry_in"]))


def test_the_temporal_count_against_a_hand_count():
    """VDA-Large at 294x518, one feed: the four modules' operations and the
    window's bytes of one step, by hand, and the step's FLOPs as DA-V2-Large's
    (the same trunk, neck and head) plus the temporal modules'."""
    cfg, da2 = config("vda-large-518"), config("da2-large-518")
    fam = manifest.family(cfg)
    with torch.device("meta"):
        shapes = harness.temporal_step(fam, fam.build(cfg), torch.empty(
            1, 3, *fam.model_input_size(cfg, 1080, 1920)))
    assert shapes == [(1, 777, 32, 1024), (1, 209, 32, 1024), (1, 777, 32, 256),
                      (1, 3108, 32, 256)]
    ops = 0
    for _, p, n, c in shapes:
        per_block = 4 * 2 * c * c + 2 * 2 * n * c  # q, k, v, out of the new frame; qk, pv
        geglu = 2 * c * 8 * c + 2 * 4 * c * c
        ops += p * (2 * c * c + 2 * per_block + geglu + 2 * c * c)
    assert roofline.temporal_ops(shapes) == ops
    assert 56e9 < ops < 58e9
    carried = 2 * 2 * 31 * (777 * 1024 + 209 * 1024 + 777 * 256 + 3108 * 256)
    assert carried == 248_523_776  # 248.5 MB a feed
    written = 2 * 2 * (777 * 1024 + 209 * 1024 + 777 * 256 + 3108 * 256)
    assert roofline.window_bytes(shapes, 2) == carried + written
    step, attn = harness.model_counts(fam, cfg, (1080, 1920), 4)
    base, attn_da2 = harness.model_counts(manifest.family(da2), da2, (1080, 1920), 4)
    assert attn == attn_da2 == [(4, 778, 16, 64)] * 24
    assert step == base + ops
