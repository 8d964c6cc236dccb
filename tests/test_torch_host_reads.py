"""The frame path's stages enqueue their work without waiting for the card,
so the compute thread can run ahead of it.

A host read shows in the dispatcher as `aten._local_scalar_dense` (`aten.item`
under `inference_mode`); `nonzero`, `is_nonzero` and `equal` read too.  A
tensor made from Python data (`torch.tensor`, `aten.lift_fresh`) is an upload
from pageable memory on the card, which waits for the card's queue as a read
does.  The metric depth normalisation picks its two percentiles by a device
gather, and gives the same bits as the formula indexed with Python ints.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import desktop2stereo_tpu_torch.models.depthpro as T_dp
from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.models.factory import init_random
from desktop2stereo_tpu_torch.ops import depth_post as T_post
from desktop2stereo_tpu_torch.pipeline import programs as T_programs
from torch_threads import one_torch_thread  # noqa: F401

HOST_WAITS = {torch.ops.aten.item, torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.is_nonzero, torch.ops.aten.equal, torch.ops.aten.lift_fresh}
# tests/test_torch_depthpro.py's small configuration, on its 128² input
SMALL = dict(patch_px=32, vit_hidden=32, vit_layers=4, vit_heads=4, vit_mlp=128, vit_patch=8,
             fusion=16, scaled_dims=(32, 32, 16), hook_ids=(2, 1), hook_dims=(16, 16))
CFG = dict(model_name="DepthPro-Large", depth_resolution=128, output_height=180,
           display_mode="Half-SBS", ipd=0.064, depth_strength=2.0, convergence=0.01,
           foreground_scale=0.3, aa_strength=2.0, ema_alpha=0.9, temporal_smooth=True,
           quality="high", emit_depth="model")


class HostWaits(TorchDispatchMode):
    """Collects the name of every op that reads a device value on the host
    or uploads host data."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_WAITS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _depth_field(seed, shape, invalid=0.1):
    """A smooth positive field with a share of invalid (zero or negative) pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    d = 3.0 + np.sin(xx / 9.0) + np.cos(yy / 7.0) + 0.3 * rng.standard_normal(shape)
    bad = rng.random(shape) < invalid
    d[bad] = -rng.random(int(bad.sum()))
    return torch.from_numpy(d.astype(np.float32))


BELOW, ABOVE = (42, 70), (96, 128)  # 2 940 and 12 288 values: SUBSAMPLE_CAP lies between
assert BELOW[0] * BELOW[1] <= T_post.SUBSAMPLE_CAP < ABOVE[0] * ABOVE[1]


def _post_program(streams):
    prog = T_programs.FrameProgram(T_programs.ProgramConfig(**CFG), torch.nn.Identity(),
                                   get_spec("DepthPro-Large"), compute_dtype=torch.float32,
                                   streams=streams)
    assert prog.spec.metric
    raw = torch.stack([_depth_field(s, (128, 128)) for s in range(max(1, streams))])
    ema_prev = torch.rand(raw.shape, generator=torch.Generator().manual_seed(1))
    ema_prev[0, :4] = torch.nan  # rows the EMA passes through
    if not streams:
        raw, ema_prev = raw[0], ema_prev[0]
    return lambda: prog.post_stage(raw, ema_prev)


def _depthpro(whole):
    """A tiny DepthPro's model stage, or a whole ProgramCache call
    (preprocess, model, the fused Half-SBS tail, the EMA carried)."""
    model = init_random(T_dp.DepthPro(**SMALL), seed=0).eval()
    cfg, spec = T_programs.ProgramConfig(**CFG), get_spec("DepthPro-Large")
    if whole:
        prog = T_programs.ProgramCache(cfg, model, spec, compute_dtype=torch.float32)
        frame = torch.randint(0, 256, (180, 320, 4), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(2))
        return lambda: prog(frame)
    prog = T_programs.FrameProgram(cfg, model, spec, compute_dtype=torch.float32)
    model_in = torch.randn(1, 128, 128, 3, generator=torch.Generator().manual_seed(2))
    return lambda: prog.model_stage(model_in)


def _stage(case):
    """case → a call of the stage on fixed inputs."""
    kind, rest = case.split(":")
    if kind in ("normalize", "post"):
        metric, size = rest.split("-")
        d = _depth_field(3, BELOW if size == "below" else ABOVE)
        fn = T_post.normalize_depth if kind == "normalize" else T_post.post_process_depth
        return lambda: fn(d, metric=metric == "metric")
    if kind == "post_stage":
        return _post_program(int(rest))
    return _depthpro(whole=kind == "program_call")


@pytest.mark.parametrize("inference", [False, True], ids=["grad_mode", "inference_mode"])
@pytest.mark.parametrize("case", [
    f"{kind}:{metric}-{size}" for kind in ("normalize", "post")
    for metric in ("metric", "relative") for size in ("below", "above")
] + ["post_stage:0", "post_stage:2", "model_stage:depthpro", "program_call:depthpro"])
def test_stage_waits_on_nothing(case, inference):
    """Metric and relative post below and above the subsample cap, the
    program's post stage for a metric model with and without a stream axis
    (S = 2), a tiny DepthPro's model stage and a whole frame of it through
    ProgramCache: no op reads a device value or uploads host data."""
    call = _stage(case)
    call()  # a first call fills the device tables (resize, normalisation), as the warm-up does
    with torch.inference_mode(inference), HostWaits() as waits:
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(t).all() for t in outs if isinstance(t, torch.Tensor))
    assert waits.seen == []


def _normalize_metric_int_indices(depth, percentile=T_post.PERCENTILE,
                                  subsample_cap=T_post.SUBSAMPLE_CAP):
    """The metric normalisation as it was, its sorted depths indexed with
    Python ints read from the count."""
    d = depth.float().squeeze()
    flat = d.reshape(-1)
    valid = flat > 0
    inv_flat = torch.where(valid, 1.0 / flat.clamp_min(1e-12), flat)
    v = T_post._subsample(inv_flat, subsample_cap)
    valid_s = T_post._subsample(valid.to(torch.int32), subsample_cap)
    n = v.shape[0]
    sorted_v = torch.sort(torch.where(valid_s > 0, v, torch.inf)).values
    count = valid_s.sum()
    tc = torch.clamp(torch.round(percentile / 100.0 * (count - 1).float())
                     .to(torch.int32) + 1, 1, None)
    tc = int(torch.minimum(tc, count.clamp_min(1)))
    lo = sorted_v[min(max(tc - 1, 0), n - 1)]
    hi = sorted_v[min(max(int(count) - tc, 0), n - 1)]
    if int(count) <= 10:
        lo, hi = torch.zeros_like(lo), torch.zeros_like(hi)
    denom = torch.clamp(hi - lo, min=1e-6)
    return torch.clamp((inv_flat.reshape(d.shape) - lo) / denom, 0.0, 1.0)


def _few_valid(shape, k):
    d = torch.zeros(shape)
    d.view(-1)[torch.randperm(d.numel(), generator=torch.Generator().manual_seed(k))[:k]] = (
        torch.linspace(0.5, 4.0, k))
    return d


FIELDS = {
    "invalid_pixels": lambda: _depth_field(4, BELOW, invalid=0.3),
    "ten_valid": lambda: _few_valid(BELOW, 10),
    "eleven_valid": lambda: _few_valid(BELOW, 11),
    "none_valid": lambda: -torch.rand(BELOW, generator=torch.Generator().manual_seed(5)),
    "above_cap": lambda: _depth_field(6, ABOVE, invalid=0.2),
    "above_cap_batched": lambda: _depth_field(7, ABOVE)[None, None],
}


@pytest.mark.parametrize("percentile", [T_post.PERCENTILE, 10.0])
@pytest.mark.parametrize("field", list(FIELDS))
def test_metric_normalisation_is_bit_identical_to_int_indexing(field, percentile):
    d = FIELDS[field]()
    got = T_post.normalize_depth(d, metric=True, percentile=percentile)
    want = _normalize_metric_int_indices(d, percentile=percentile)
    assert got.shape == want.shape == d.squeeze().shape
    assert torch.equal(got, want)
