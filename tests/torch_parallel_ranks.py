"""Rank bodies for tests/test_torch_parallel.py.

Each function here runs in a process of its own (`parallel/launch.py:
spawn`), so this module imports torch, numpy and the port only, never JAX
or a test module.  The pytest process hands over numpy state dicts and
inputs; every rank computes its own cases and rank 0 returns all ranks'
results, gathered with `all_gather_object`.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.core.runtime import make_mesh
from desktop2stereo_tpu_torch.models.da3 import DA3Backbone
from desktop2stereo_tpu_torch.models.beit import BeitEncoder
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder
from desktop2stereo_tpu_torch.models.dpt_vit import DPTViT
from desktop2stereo_tpu_torch.models.infinidepth import Dinov3Backbone
from desktop2stereo_tpu_torch.ops.kernels.quant_matmul import quant_dense_ref
from desktop2stereo_tpu_torch.ops.quant import tp_quant_dense
from desktop2stereo_tpu_torch.parallel.sharding import (
    ParallelContext, parallel_frame_apply, shard_model)

DA2 = "Depth-Anything-V2-Small"


def _load(model, state):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model.eval()


def _da2(state, quant=False):
    return _load(DepthAnything.from_spec(get_spec(DA2), quant=quant), state)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else [_np(u) for u in t]


def _max_abs(a, b):
    if isinstance(a, (list, tuple)):
        return max(_max_abs(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        return all(_equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _module(kind, cfg):
    return {"da3": DA3Backbone, "beit": BeitEncoder, "giant": Dinov2Encoder,
            "infinidepth": Dinov3Backbone, "dpt": DPTViT}[kind](**cfg)


def _first(out):
    """The trunk's output the tests compare: DA3's patch features, BEiT's
    feature list, the DINOv2 tuple, DINOv3's tokens."""
    if isinstance(out, tuple) and len(out) == 3 and isinstance(out[1], int):  # BEiT
        return list(out[0])
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], (list, tuple)):  # DA3
        return list(out[0])
    return list(out) if isinstance(out, (list, tuple)) else out


@torch.no_grad()
def main_cases(ctx, data):
    """Every case on a 2x2 mesh (ctx) and a 1x4 mesh built beside it."""
    ctx4 = ParallelContext(make_mesh(1, 4, "cpu"))
    pixels = torch.from_numpy(data["pixels"])          # [2, 56, 56, 3]
    d = ctx.data_index
    mine = pixels[d:d + 1]
    res = {"rank": ctx.rank, "data_index": d, "model_index": ctx.model_index,
           "backend": ctx.backend}

    # an unsharded model, run before anything is sharded and again at the end
    plain = _da2(data["da2"])
    plain_before = plain(mine)

    # -- DP x TP: 2x2, float --------------------------------------------------
    one_frame = _da2(data["da2"])(mine)
    tp2 = shard_model(_da2(data["da2"]), ctx)
    run = parallel_frame_apply(tp2, ctx)
    out = run(pixels)
    res["tp2"] = dict(out=_np(out), vs_unsharded=_max_abs(out, one_frame),
                      whole=_np(ctx.gather(out)),
                      heads=tp2.backbone.layer[0].attention.num_heads,
                      proj=type(tp2.backbone.layer[0].attention.proj).__name__,
                      fc1=tuple(tp2.backbone.layer[0].mlp.fc1.weight.shape),
                      scale=float(one_frame.abs().max()))
    sp = parallel_frame_apply(tp2, ctx, sequence_parallel=True)(pixels)
    res["sp2"] = dict(out=_np(sp), vs_unsharded=_max_abs(sp, one_frame))
    try:
        run(pixels[:1])
        res["odd_batch"] = None
    except ValueError as e:
        res["odd_batch"] = str(e)

    # -- TP = 4 over one frame: attention whole (6 heads), MLP split ------------
    ref4 = _da2(data["da2"])(pixels[:1])
    tp4 = shard_model(_da2(data["da2"]), ctx4)
    out4 = parallel_frame_apply(tp4, ctx4)(pixels[:1])
    sp4 = parallel_frame_apply(tp4, ctx4, sequence_parallel=True)(pixels[:1])
    att, mlp = tp4.backbone.layer[0].attention, tp4.backbone.layer[0].mlp
    res["tp4"] = dict(out=_np(out4), vs_unsharded=_max_abs(out4, ref4),
                      sp_vs_unsharded=_max_abs(sp4, ref4), sp=_np(sp4),
                      heads=att.num_heads, qkv=type(att.qkv).__name__,
                      qkv_shape=tuple(att.qkv.weight.shape), fc2=type(mlp.fc2).__name__,
                      fc2_shape=tuple(mlp.fc2.weight.shape))

    # -- int8 at TP = 2 --------------------------------------------------------
    q_ref = _da2(data["da2_q"], quant=True)(mine)
    tpq = shard_model(_da2(data["da2_q"], quant=True), ctx)
    q_out = parallel_frame_apply(tpq, ctx)(pixels)
    q_sp = parallel_frame_apply(tpq, ctx, sequence_parallel=True)(pixels)
    qkv = tpq.backbone.layer[0].attention.qkv
    res["int8"] = dict(out=_np(q_out), equal=_equal(q_out, q_ref),
                       vs_unsharded=_max_abs(q_out, q_ref), sp_equal=_equal(q_sp, q_ref),
                       qkv_type=type(qkv).__name__, qkv_dtype=str(qkv.weight_q.dtype),
                       qkv_shape=tuple(qkv.weight_q.shape), scale_shape=tuple(qkv.scale.shape),
                       qkv_q=qkv.weight_q.numpy().copy(), qkv_scale=qkv.scale.numpy().copy())

    # -- tp_quant_dense at the JAX test's shapes -------------------------------
    tq = {}
    for role, (x, wq, s, b) in data["tq"].items():
        x, wq, s, b = (torch.from_numpy(a) for a in (x, wq, s, b))
        want = quant_dense_ref(x, wq, s, b)
        r, tp = ctx.model_index, ctx.tp
        if role == "col":
            f = wq.shape[0] // tp
            got = tp_quant_dense(ctx, x, wq[r * f:(r + 1) * f].contiguous(),
                                 s[r * f:(r + 1) * f], b[r * f:(r + 1) * f], "col")
            want = want[..., r * f:(r + 1) * f]
        else:
            k = wq.shape[1] // tp
            got = tp_quant_dense(ctx, x[..., r * k:(r + 1) * k].contiguous(),
                                 wq[:, r * k:(r + 1) * k].contiguous(), s, b, "row")
        tq[role] = dict(equal=_equal(got, want), max_abs=_max_abs(got, want))
    res["tp_quant_dense"] = tq

    # -- the other families at TP = 2 ------------------------------------------
    fam = {}
    for kind, (cfg, state, x, call_kw) in data["families"].items():
        x = torch.from_numpy(x)
        whole = _load(_module(kind, cfg), state)
        ref = _first(whole(x, **call_kw))
        # a bare trunk: its layers are the scope ("backbone" in a whole
        # model); DPTViT names its own (`tp_scopes`)
        sharded = shard_model(_load(_module(kind, cfg), state), ctx,
                              scopes=None if kind == "dpt" else ("layer",))
        got = _first(sharded(x, **call_kw))
        fam[kind] = dict(out=_np(got), vs_unsharded=_max_abs(got, ref),
                         heads=[getattr(m, "attention", m).num_heads for m in sharded.layer])
        if kind == "giant":
            sp = _first(parallel_frame_apply(sharded, ctx, sequence_parallel=True)(
                x.expand(2, *x.shape[1:])))
            fam[kind]["sp_vs_unsharded"] = _max_abs(sp, ref)
    res["families"] = fam

    # -- no leaks: the sharded models again, in turn, and the unsharded one ----
    res["again"] = dict(tp2=_equal(run(pixels), out),
                        tp4=_equal(parallel_frame_apply(tp4, ctx4)(pixels[:1]), out4),
                        int8=_equal(parallel_frame_apply(tpq, ctx)(pixels), q_out))
    res["plain_unchanged"] = _equal(plain(mine), plain_before)

    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, res)
    return everyone


def fails(ctx, how):
    """Rank 1 raises (or dies); the others wait in a collective for it."""
    if ctx.rank == 1:
        if how == "dies":
            os._exit(3)
        raise ValueError("rank 1 fails on purpose")
    ctx.model_all_reduce(torch.ones(4))
    return np.ones(1)


@torch.no_grad()
def card_tp(ctx):
    """DA-V2-Small @56 x 98 at TP = 2 on the card, bf16 and int8, against
    the same model whole on the same card; K2 and K4 launches a rank."""
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.parallel.introspect import count_launches

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 56, 98, 3), dtype=np.float32)).to(ctx.device, torch.bfloat16)
    res = {"backend": ctx.backend, "device": str(ctx.device)}
    for quant in ("none", "int8"):
        whole, _ = build_bound(DA2, device=ctx.device, quant=quant)
        ref = whole(x)
        net, _ = build_bound(DA2, device="cpu", dtype=torch.bfloat16, quant=quant)
        out, launches = count_launches(parallel_frame_apply(shard_model(net, ctx), ctx), x)
        span = (ref.float().max() - ref.float().min()).item()
        res[quant] = dict(launches=launches, equal=_equal(out, ref),
                          mean_rel=float((out.float() - ref.float()).abs().mean()) / span,
                          finite=bool(torch.isfinite(out).all()))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, res)
    return everyone
