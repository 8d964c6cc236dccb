"""Every classic-DPT registry name that no other test builds goes through
`build_bound(name, device="cpu")` at its real widths with seeded weights,
float and int8, and runs one small input: the registry entry, its family's
builder, its preset and its int8 scope stay wired together.  The names
built elsewhere, and the two ViT-G names (built on the card by
chip_smoke.py), are listed so that a new registry name cannot go unbuilt.

The weights are drawn from the seed with an untruncated normal in place of
`init_random`'s truncated one, which is the same code for every name (the
build tests listed in BUILT_ELSEWHERE run it) and takes ~20 s a ViT-L on
one CPU thread.
"""

import numpy as np
import pytest
import torch

from desktop2stereo_tpu_torch.core.registry import MODEL_REGISTRY
from desktop2stereo_tpu_torch.ops.quant import QuantLinear
from torch_threads import one_torch_thread  # noqa: F401

# name → QuantLinear modules under quant="int8": 4 products a layer (fused
# qkv, proj, fc1, fc2), 6 for BEiT (query, key, value, proj, fc1, fc2)
INT8_PRODUCTS = {
    "dpt-large": 24 * 4,
    "dpt-large-redesign": 24 * 4,
    "dpt-dinov2-small-nyu": 12 * 4,
    "dpt-dinov2-base-kitti": 12 * 4,
    "dpt-dinov2-large-kitti": 24 * 4,
    "dpt-dinov2-large-nyu": 24 * 4,
    "dpt-beit-large-512": 24 * 6,
}
BUILT_ELSEWHERE = {
    "dpt-dinov2-small-kitti": "test_torch_dpt_vit.py::test_quant_none_is_float_for_dpt_dinov2",
    "dpt-dinov2-base-nyu": "test_torch_dpt_vit.py::test_quant_none_is_float_for_dpt_dinov2",
    "dpt-hybrid-midas": "test_torch_dpt_hybrid.py::test_build_bound_runs_dpt_hybrid_midas_float_and_int8",
    "dpt-beit-base-384": "test_torch_beit.py::test_build_bound_runs_dpt_beit_base_float_and_int8",
    "dpt-dinov2-giant-kitti": "chip_smoke.py phase 34",
    "dpt-dinov2-giant-nyu": "chip_smoke.py phase 34",
}
CLASSIC_FAMILIES = ("dpt", "dpt_dinov2", "dpt_hybrid", "dpt_beit")
GRID = (4, 6)  # patches; the head's depth is 16 pixels a patch in every family


def test_every_classic_name_is_built_somewhere():
    served = {n for n, s in MODEL_REGISTRY.items() if s.family in CLASSIC_FAMILIES}
    assert served == set(INT8_PRODUCTS) | set(BUILT_ELSEWHERE)
    assert not set(INT8_PRODUCTS) & set(BUILT_ELSEWHERE)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("name", sorted(INT8_PRODUCTS))
def test_build_bound_builds_and_runs(name, quant, monkeypatch):
    import desktop2stereo_tpu_torch.models.factory as factory

    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", ())
    monkeypatch.setattr(factory, "_lecun_", lambda w, fan_in, gen: w.normal_(
        0.0, fan_in ** -0.5, generator=gen))
    monkeypatch.setenv("HF_HOME", "/nonexistent")
    model, spec = factory.build_bound(name, device="cpu", quant=quant)
    assert spec.norm_family == "half"
    assert (sum(isinstance(m, QuantLinear) for m in model.modules())
            == (INT8_PRODUCTS[name] if quant == "int8" else 0))
    p = spec.patch_size
    x = torch.from_numpy(np.random.default_rng(len(name)).standard_normal(
        (1, GRID[0] * p, GRID[1] * p, 3)).astype(np.float32))
    with torch.no_grad():
        if spec.family == "dpt_beit":  # stateful: the carry is the layers' tables
            depth, carry = model.first(x)
            again, carry_again = model.step(x, carry)
            assert carry_again is carry and len(carry) == 24 and torch.equal(depth, again)
        else:
            depth = model(x)
    assert depth.shape == (1, 16 * GRID[0], 16 * GRID[1])
    assert bool(torch.isfinite(depth).all())
