"""The port's multi-GPU path (`desktop2stereo_tpu_torch/parallel/`) on the CPU.

The port's counterpart of tests/test_parallel.py.  The JAX references run
here, in the pytest process: DA-V2-Small from the JAX `build_model` at 56
(17 tokens: 16 patches and the cls token), float and int8, and four tiny
trunks from the JAX modules (DA3 with QK-norm, RoPE and cross-view layers,
BEiT with its relative-position table, a ViT-G-geometry SwiGLU DINOv2,
InfiniDepth's DINOv3), their weights moved by seeded noise.  The sharded
runs happen in one group of four spawned ranks over gloo (`parallel/
launch.py:spawn`, `tests/torch_parallel_ranks.py`), which imports no JAX:
a 2x2 (data x model) mesh and a 1x4 mesh beside it.  Layouts and roles need
no process group and are checked here.
"""

import re
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import desktop2stereo_tpu.models.beit as J_beit
import desktop2stereo_tpu.models.da3 as J_da3
import desktop2stereo_tpu.models.dinov2 as J_dinov2
import desktop2stereo_tpu.models.dpt_vit as J_dpt_vit
import desktop2stereo_tpu.models.infinidepth as J_inf
import desktop2stereo_tpu.parallel.sharding as J_sh
from desktop2stereo_tpu.core.runtime import MODEL_AXIS as J_MODEL_AXIS
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu.models.factory import build_model
from desktop2stereo_tpu.models.init_util import jit_init
from desktop2stereo_tpu.ops.quant import quantize_tree
from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.core.runtime import DATA_AXIS, MODEL_AXIS, Mesh
from desktop2stereo_tpu_torch.models.da3 import DA3Backbone
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.ops.quant import QuantLinear, quantize_weight, tp_quant_dense
from desktop2stereo_tpu_torch.parallel import sharding as T_sh
from desktop2stereo_tpu_torch.parallel.introspect import count_launches, launch_counts
from desktop2stereo_tpu_torch.parallel.launch import RankFailed, spawn
from torch_threads import one_torch_thread  # noqa: F401

import torch_parallel_ranks as ranks

DA2 = "Depth-Anything-V2-Small"
REL_TOL = 5e-4      # the port's DA-V2 / DA3 f32 tolerance against JAX (test_torch_models.py)
F32_TOL = 1e-5      # the classic DPT / InfiniDepth f32 tolerance (torch_classic_dpt.py)
SHARD_TOL = 1e-5    # sharded against unsharded, f32 (tests/test_parallel.py)

TRUNKS = {   # kind → (JAX module, port config, input shape, JAX call keywords)
    "da3": (lambda: J_da3.DA3Backbone(128, 4, 2, 256, (1, 3), alt_start=2, qknorm_start=2,
                                      rope_start=2),
            dict(hidden_size=128, num_layers=4, num_heads=2, mlp_dim=256, out_layers=(1, 3),
                 alt_start=2), (1, 2, 28, 42, 3)),
    "beit": (lambda: J_beit.BeitEncoder(128, 2, 2, 256, (0, 1), pretrain_window=4),
             dict(hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256, out_indices=(0, 1),
                  pretrain_window=4), (1, 48, 80, 3)),
    "giant": (lambda: J_dinov2.Dinov2Encoder(128, 2, 2, 256, (0, 1), use_swiglu=True),
              dict(hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256, out_layers=(0, 1),
                   use_swiglu=True), (1, 42, 56, 3)),
    "infinidepth": (lambda: J_inf.Dinov3Backbone(128, 2, 2, 256, use_swiglu=True),
                    dict(embed_dim=128, depth=2, num_heads=2, ffn_hidden=256, use_swiglu=True),
                    (1, 32, 48, 3)),
    # a whole dpt-large-shaped model: its ViT layers sit at the top level
    # (`tp_scopes`), the readout decoder stays whole
    "dpt": (lambda: J_dpt_vit.DPTViT(128, 4, 2, 256, (0, 1, 2, 3), (16, 32, 64, 64), 32),
            dict(hidden_size=128, num_layers=4, num_heads=2, mlp_dim=256, out_indices=(0, 1, 2, 3),
                 neck_channels=(16, 32, 64, 64), fusion_channels=32), (1, 64, 96, 3)),
}
TRUNK_TOL = {"da3": REL_TOL, "beit": F32_TOL, "giant": REL_TOL, "infinidepth": F32_TOL,
             "dpt": F32_TOL}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _perturb(params, seed):
    """Every leaf moved by seeded noise, so that zero tables, unit norms and
    zero biases take part (BEiT's tables drawn from N(0, 1))."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf, np.float32)
        if "relative_position_bias_table" in jax.tree_util.keystr(path):
            return rng.standard_normal(a.shape).astype(np.float32)
        std = 0.5 * float(a.std()) if a.size > 1 and a.std() > 0 else 0.05
        return (a + std * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, params)


def _first(out):
    if isinstance(out, tuple) and len(out) == 3:          # BEiT: feats, gh, gw
        return list(out[0])
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], (list, tuple)):
        return list(out[0])                               # DA3: feats, camera tokens
    return [np.asarray(o) for o in out] if isinstance(out, (list, tuple)) else out


def _numpy_state(params):
    return {k: v.numpy() for k, v in from_flax(params).items()}


@pytest.fixture(scope="module")
def suite():
    """The JAX side and the sharded runs: DA-V2-Small float and int8 from
    `build_model` at 56, and the four trunks from the JAX modules, every
    weight moved by seeded noise; one group of four ranks runs every sharded
    case on the port's copies of those weights while this process computes
    the JAX outputs.  → (JAX references, the ranks' results by rank)."""
    pixels = np.random.default_rng(1).standard_normal((2, 56, 56, 3)).astype(np.float32)

    def da2():
        apply_fn, params, spec = build_model(DA2, init_size=56)
        # the draw moved by noise (its zero head would make every depth 0),
        # and the int8 model as `build_model(..., quant="int8")` makes it
        params = _perturb(params, 5)
        return apply_fn, params, JDepthAnything.from_spec(spec, quant=True).apply, \
            quantize_tree(params)

    def trunk(i, kind):
        make, cfg, shape = TRUNKS[kind]
        jm = make()
        p = _perturb(jit_init(jm, jnp.zeros(shape, jnp.float32), rng_seed=i), 20 + i)
        return jm, cfg, p, np.random.default_rng(10 + i).standard_normal(shape).astype(
            np.float32)

    def jax_out(fn, p, x):
        out = _first(jax.jit(fn)(p, jnp.asarray(x)))
        return [np.asarray(w) for w in out] if isinstance(out, list) else np.asarray(out)

    # the JAX compiles run side by side, and the JAX outputs beside the ranks
    with ThreadPoolExecutor(len(TRUNKS) + 2) as pool:
        da2_job = pool.submit(da2)
        trunk_jobs = {kind: pool.submit(trunk, i, kind) for i, kind in enumerate(TRUNKS)}
        apply_fn, params, q_apply, q_params = da2_job.result()
        trunks = {kind: job.result() for kind, job in trunk_jobs.items()}
        data = {"pixels": pixels, "da2": _numpy_state(params),
                "da2_q": _numpy_state(q_params), "tq": _tq_inputs(),
                "families": {kind: (cfg, _numpy_state(p), x, {})
                             for kind, (_, cfg, p, x) in trunks.items()}}
        ranks_run = pool.submit(spawn, ranks.main_cases, 2, 2, "cpu", data, deadline_s=300.0)
        jobs = {"da2": pool.submit(jax_out, apply_fn, params, pixels),
                "da2_q": pool.submit(jax_out, q_apply, q_params, pixels),
                **{kind: pool.submit(jax_out, jm.apply, p, x)
                   for kind, (jm, _, p, x) in trunks.items()}}
        refs = {"pixels": pixels, "params": params, "q_params": q_params,
                "da2": jobs["da2"].result(), "da2_q": jobs["da2_q"].result(),
                "trunks": {kind: (cfg, p, x, jobs[kind].result())
                           for kind, (_, cfg, p, x) in trunks.items()}}
        out = ranks_run.result()
    return refs, sorted(out, key=lambda r: r["rank"])


@pytest.fixture(scope="module")
def refs(suite):
    return suite[0]


@pytest.fixture(scope="module")
def ranks_out(suite):
    return suite[1]


def _tq_inputs():
    """tp_quant_dense's cases at tests/test_parallel.py's shapes: col x
    [2, 16, 256] · [256, 512], row x [2, 16, 512] · [512, 256]."""
    rng = np.random.default_rng(0)
    cases = {}
    for role, (k, f) in (("col", (256, 512)), ("row", (512, 256))):
        x = rng.standard_normal((2, 16, k)).astype(np.float32)
        wq, s = quantize_weight(torch.from_numpy(rng.standard_normal((f, k)).astype(np.float32)))
        b = rng.standard_normal(f).astype(np.float32)
        cases[role] = (x, wq.numpy(), s.numpy(), b)
    return cases


def _fake_ctx(tp, r):
    """A context that only places this rank (layouts need no collective)."""
    return T_sh.ParallelContext(Mesh(1, tp, r, 0, r, None, None, torch.device("cpu"), "gloo"))


# ---- roles and specs ---------------------------------------------------------------------

def _port_key(names):
    """A JAX leaf path → the port's dotted state-dict key (kernel → weight)."""
    key = ".".join(re.sub(r"^(.*)_(\d+)$", r"\1.\2", n) for n in names[:-1])
    leaf = {"kernel": "weight", "kernel_q": "weight_q"}.get(names[-1], names[-1])
    return f"{key}.{leaf}"


def _jax_trees(refs):
    trees = {"da2": refs["params"], "da2_q": refs["q_params"]}
    for kind, (_, p, _, _) in refs["trunks"].items():
        trees[kind] = {"params": {"backbone": p["params"]}}
    # a decoder Dense reusing encoder names, and VDA's exact-match trap
    trees["decoder"] = {"params": {
        "backbone": {"layer_0": {"mlp": {"fc1": {"kernel": np.ones((8, 32))}}},
                     "temporal": {"proj_in": {"kernel": np.ones((8, 8))}}},
        "cam_dec": {"fc1": {"kernel": np.ones((8, 32))}, "proj": {"kernel": np.ones((8, 8))}}}}
    return trees


def test_roles_and_specs_match_jax(refs):
    """Every Dense name in the JAX trees (DA-V2 float and int8, DA3, BEiT,
    the giant SwiGLU, InfiniDepth): the port's megatron_role is the JAX
    one, and tp_spec_for's dim is JAX `_tp_spec_for`'s axis, transposed;
    decoder products stay whole (test_tp_specs_cover_attention_and_mlp,
    test_tp_rules_scoped_to_encoder)."""
    want_dim = {P(None, J_MODEL_AXIS): 0, P(J_MODEL_AXIS): 0, P(J_MODEL_AXIS, None): 1, P(): None}
    seen = {"col": set(), "row": set()}
    for name, tree in _jax_trees(refs).items():
        hit = {0: 0, 1: 0}
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            names = re.findall(r"\['([^']+)'\]", jax.tree_util.keystr(path))
            parent = names[-2]
            assert T_sh.megatron_role(parent) == J_sh.megatron_role(parent), parent
            shape = np.shape(leaf)
            port_shape = shape[::-1] if len(shape) == 2 else shape
            dim = T_sh.tp_spec_for(_port_key(names[1:]), port_shape)
            assert dim == want_dim[J_sh._tp_spec_for(jax.tree_util.keystr(path), shape)], (
                name, names)
            if dim is not None:
                hit[dim] += 1
                seen[T_sh.megatron_role(parent)].add(parent)
        if name != "decoder":
            assert hit[0] > 0 and hit[1] > 0, (name, hit)
        else:
            assert hit == {0: 1, 1: 0}  # only the encoder's fc1
    assert seen["col"] == {"qkv", "fc1", "query", "key", "value", "weights_in", "w1", "w2"}
    assert seen["row"] == {"proj", "fc2", "weights_out", "w3"}
    assert (DATA_AXIS, MODEL_AXIS) == ("data", "model")


# ---- layouts -------------------------------------------------------------------------------

def test_qkv_shards_reassemble_head_by_head(refs):
    """The ranks' qkv shards hold the q, k and v rows of their heads:
    stacking the ranks' thirds gives each whole third back; fc1 splits in
    row blocks, proj and fc2 in column blocks, the decoder stays whole."""
    state = from_flax(refs["params"])
    model = DepthAnything.from_spec(get_spec(DA2))
    heads = T_sh.head_counts(model)
    assert heads["backbone.layer.0.attention"] == 6
    shards = [T_sh.shard_params(state, _fake_ctx(2, r), heads) for r in range(2)]
    key = "backbone.layer.3.attention.qkv"
    whole = state[f"{key}.weight"].reshape(3, 384, 384)
    for part in range(3):
        stacked = torch.cat([s[f"{key}.weight"].reshape(3, 192, 384)[part] for s in shards])
        assert torch.equal(stacked, whole[part])
        bias = torch.cat([s[f"{key}.bias"].reshape(3, 192)[part] for s in shards])
        assert torch.equal(bias, state[f"{key}.bias"].reshape(3, 384)[part])
    proj = "backbone.layer.3.attention.proj.weight"
    assert torch.equal(torch.cat([s[proj] for s in shards], dim=1), state[proj])
    fc1 = "backbone.layer.3.mlp.fc1.weight"
    assert torch.equal(torch.cat([s[fc1] for s in shards], dim=0), state[fc1])
    for k, t in state.items():
        if not k.startswith("backbone.layer."):
            assert shards[1][k] is t, k  # the decoder, embeddings and norms: whole
        else:
            assert shards[1][k].data_ptr() != t.data_ptr() or shards[1][k].shape == t.shape


@pytest.mark.parametrize("kind,name", [("giant", "weights_in"), ("da3", "w12")])
def test_swiglu_pairs_reassemble_pair_by_pair(kind, name):
    """weights_in / w12 hold the same hidden indices of x1 and x2 on a rank."""
    if kind == "giant":
        model = Dinov2Encoder(128, 1, 2, 256, (0,), use_swiglu=True)
        key = f"layer.0.mlp.{name}"
    else:
        model = DA3Backbone(128, 1, 2, 256, (0,), use_swiglu=True)
        key = f"layer.0.mlp.{name}"
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p)
    state = model.state_dict()
    heads = T_sh.head_counts(model)
    shards = [T_sh.shard_params(state, _fake_ctx(2, r), heads, scopes=("layer",))
              for r in range(2)]
    h = state[f"{key}.weight"].shape[0] // 2
    for half in range(2):
        stacked = torch.cat([s[f"{key}.weight"].reshape(2, h // 2, -1)[half] for s in shards])
        assert torch.equal(stacked, state[f"{key}.weight"].reshape(2, h, -1)[half])
    out = key.replace(name, "weights_out" if kind == "giant" else "w3") + ".weight"
    assert torch.equal(torch.cat([s[out] for s in shards], dim=1), state[out])


def test_divisibility_guard_keeps_units_whole(refs):
    """ViT-S at tp=4: 6 heads do not split, so qkv and proj stay whole on
    every rank; the MLP (1536 wide) splits (test_divisibility_guard_replicates).
    An int8 unit whose row-parallel slice K4 cannot take stays whole too."""
    state = from_flax(refs["params"])
    model = DepthAnything.from_spec(get_spec(DA2))
    units = T_sh.plan(state, 4, T_sh.head_counts(model))
    assert not units[("backbone.layer.0.attention", "attention")].split
    assert units[("backbone.layer.0.mlp", "mlp")].split
    shard = T_sh.shard_params(state, _fake_ctx(4, 3), T_sh.head_counts(model))
    qkv = "backbone.layer.0.attention.qkv.weight"
    assert shard[qkv] is state[qkv]
    assert tuple(shard["backbone.layer.0.mlp.fc1.weight"].shape) == (384, 384)
    assert tuple(shard["backbone.layer.0.mlp.fc2.weight"].shape) == (384, 384)

    # int8: hidden 96 with 2 heads leaves proj 48 inputs a rank (not a
    # multiple of 32); the MLP's 192 leaves 96
    enc = Dinov2Encoder(96, 1, 2, 192, (0,), quant=True)
    units = T_sh.plan(enc.state_dict(), 2, T_sh.head_counts(enc), scopes=("layer",))
    assert not units[("layer.0.attention", "attention")].split
    assert units[("layer.0.mlp", "mlp")].split
    T_sh.shard_model(enc, _fake_ctx(2, 0), scopes=("layer",))
    att, mlp = enc.layer[0].attention, enc.layer[0].mlp
    assert type(att.qkv) is QuantLinear and type(att.proj) is QuantLinear
    assert att.num_heads == 2
    assert isinstance(mlp.fc1, T_sh.ColumnParallelQuantLinear)
    assert isinstance(mlp.fc2, T_sh.RowParallelQuantLinear)
    assert tuple(mlp.fc2.weight_q.shape) == (96, 96) and tuple(mlp.fc2.scale.shape) == (96,)


def test_tp_quant_dense_declines_where_k4_cannot_take_the_slice():
    """The row-parallel slice [2, 16, 48] (K = 96 at tp = 2) is not a
    multiple of K4's 32: the function declines before any collective."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 48)).astype(np.float32))
    wq, s = quantize_weight(torch.from_numpy(rng.standard_normal((256, 48)).astype(np.float32)))
    assert tp_quant_dense(_fake_ctx(2, 0), x, wq, s, None, "row") is None
    with pytest.raises(ValueError, match="role"):
        tp_quant_dense(_fake_ctx(2, 0), x, wq, s, None, "both")


def test_count_launches_counts_nothing_on_the_cpu():
    """The CPU takes the plain versions: a sharded-style call launches no
    kernel, and every kernel entry is listed."""
    counts = launch_counts()
    assert {"d2s_attention_fwd", "d2s_attention_relpos_fwd", "d2s_quant_dense",
            "d2s_dibr_pair_half", "d2s_horizontal_sample"} <= set(counts)
    x = torch.ones(1, 8, 2, 64)
    out, launches = count_launches(lambda t: t * 2, x)
    assert launches == {} and torch.equal(out, x * 2)


# ---- the sharded runs (one group of four ranks) ---------------------------------------

def test_ranks_sit_on_a_data_by_model_grid(ranks_out):
    assert [(r["data_index"], r["model_index"]) for r in ranks_out] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["backend"] for r in ranks_out} == {"gloo"}


def test_tp2_matches_jax_and_the_unsharded_model(refs, ranks_out):
    """DA-V2-Small at 56, TP = 2 on each data index: against JAX
    `build_model` applied unsharded, and against the port's unsharded model
    (test_tp_sharded_matches_unsharded); 3 heads a rank, proj row-parallel."""
    for r in ranks_out:
        t = r["tp2"]
        assert t["heads"] == 3 and t["proj"] == "RowParallelLinear" and t["fc1"] == (768, 384)
        assert _rel(t["out"], refs["da2"][r["data_index"]:r["data_index"] + 1]) < REL_TOL
        assert t["vs_unsharded"] / t["scale"] < SHARD_TOL


def test_tp4_keeps_attention_whole_and_matches(refs, ranks_out):
    for r in ranks_out:
        t = r["tp4"]
        assert t["heads"] == 6 and t["qkv"] == "Linear" and t["qkv_shape"] == (1152, 384)
        assert t["fc2"] == "RowParallelLinear" and t["fc2_shape"] == (384, 384)
        assert _rel(t["out"], refs["da2"][:1]) < REL_TOL
        assert _rel(t["sp"], refs["da2"][:1]) < REL_TOL
        assert t["vs_unsharded"] < SHARD_TOL and t["sp_vs_unsharded"] < SHARD_TOL


def test_dp_batch_matches_per_sample(refs, ranks_out):
    """2x2 on a batch of 2: each data index's block is its own frame through
    the one-frame model (test_dp_batch_matches_per_sample), the local block
    holds the data index's rows (test_data_sharded_output_layout) and
    `ctx.gather` rebuilds the batch in data order on every rank."""
    blocks = {r["data_index"]: r["tp2"]["out"] for r in ranks_out if r["model_index"] == 0}
    for r in ranks_out:
        d = r["data_index"]
        assert r["tp2"]["out"].shape == (1, 56, 56)
        np.testing.assert_array_equal(r["tp2"]["out"], blocks[d])
        np.testing.assert_array_equal(r["tp2"]["whole"], np.concatenate([blocks[0], blocks[1]]))
        assert _rel(r["tp2"]["out"][0], refs["da2"][d]) < REL_TOL
        assert "does not split over 2 data ranks" in r["odd_batch"]


def test_sp_matches_unsharded_with_padded_tokens(refs, ranks_out):
    """SP on 17 tokens: padded to 18 at tp = 2 and to 20 at tp = 4
    (test_sp_sharded_matches_unsharded)."""
    for r in ranks_out:
        assert r["sp2"]["vs_unsharded"] / r["tp2"]["scale"] < SHARD_TOL
        assert _rel(r["sp2"]["out"], refs["da2"][r["data_index"]:r["data_index"] + 1]) < REL_TOL


def test_int8_tp_is_bit_equal_to_the_unsharded_int8_model(refs, ranks_out):
    """int8 DA-V2-Small at TP = 2 (and with SP): bit-equal to the port's
    unsharded int8 model; against JAX int8 as the port's unsharded int8 model
    is held to it on inputs where roundings flip; the
    qkv shards int8 with their scales split alongside, and reassembled by
    heads they are the whole quantized weight."""
    whole = from_flax(refs["q_params"])["backbone.layer.0.attention.qkv.weight_q"]
    whole_s = from_flax(refs["q_params"])["backbone.layer.0.attention.qkv.scale"]
    parts = {}
    for r in ranks_out:
        q, d = r["int8"], r["data_index"]
        assert q["equal"] and q["sp_equal"], q["vs_unsharded"]
        # on 17 tokens a rounding decision flips between the port's and JAX's
        # f32 now and then (test_torch_quant.py's drift test): the two int8
        # models differ by less than int8 differs from float
        drift = _rel_l2(q["out"], refs["da2_q"][d:d + 1])
        noise = _rel_l2(refs["da2_q"][d:d + 1], refs["da2"][d:d + 1])
        assert drift < noise, (drift, noise, _rel(q["out"], refs["da2_q"][d:d + 1]))
        assert q["qkv_type"] == "ColumnParallelQuantLinear" and q["qkv_dtype"] == "torch.int8"
        assert q["qkv_shape"] == (576, 384) and q["scale_shape"] == (576,)
        parts[r["model_index"]] = (q["qkv_q"], q["qkv_scale"])
    for third in range(3):
        got = np.concatenate([parts[m][0].reshape(3, 192, 384)[third] for m in (0, 1)])
        np.testing.assert_array_equal(got, whole.numpy().reshape(3, 384, 384)[third])
        got = np.concatenate([parts[m][1].reshape(3, 192)[third] for m in (0, 1)])
        np.testing.assert_array_equal(got, whole_s.numpy().reshape(3, 384)[third])


def test_tp_quant_dense_matches_the_plain_version_bit_for_bit(ranks_out):
    """Col and row against `quant_dense_ref` (test_tp_quant_dense_row_col_match_oracle,
    which holds JAX's to 1e-5; the port's are exact)."""
    for r in ranks_out:
        for role in ("col", "row"):
            assert r["tp_quant_dense"][role]["equal"], (role, r["tp_quant_dense"][role])


@pytest.mark.parametrize("kind", list(TRUNKS))
def test_other_trunks_at_tp2_match_their_jax_modules(refs, ranks_out, kind):
    """DA3 (QK-norm, RoPE, cross-view layers), BEiT (its table by head
    columns), the ViT-G-geometry SwiGLU DINOv2 (also with SP), InfiniDepth's
    DINOv3 and a whole dpt-large-shaped DPTViT, each at TP = 2 with one head
    a rank, against the JAX module and the port's unsharded one."""
    want = refs["trunks"][kind][3]
    for r in ranks_out:
        f = r["families"][kind]
        assert set(f["heads"]) == {1}
        got = f["out"]
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            assert _rel(g, w) < TRUNK_TOL[kind], kind
        scale = max(np.abs(w).max() for w in (want if isinstance(want, list) else [want]))
        assert f["vs_unsharded"] / scale < SHARD_TOL
        if kind == "giant":
            assert f["sp_vs_unsharded"] / scale < SHARD_TOL


def test_sharded_models_do_not_leak(ranks_out):
    """Three sharded models of different layouts (2x2 float, 1x4 float, 2x2
    int8) run again in turn, each as before; an unsharded model in the same
    process is bit-equal before and after (test_parallel_context_is_thread_scoped,
    test_sp_hook_is_noop_outside_parallel_apply)."""
    for r in ranks_out:
        assert r["again"] == {"tp2": True, "tp4": True, "int8": True}
        assert r["plain_unchanged"]


# ---- failures ------------------------------------------------------------------------------

@pytest.mark.parametrize("how,match", [("raises", "rank 1 fails on purpose"),
                                       ("dies", "rank 1 died with exit code 3")])
def test_a_failing_rank_fails_spawn_within_seconds(how, match):
    """Rank 0 waits in an all-reduce for rank 1, which raises (or exits):
    spawn kills rank 0 and raises with rank 1's traceback, long before the
    process group's 60 s timeout."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match=match):
        spawn(ranks.fails, 1, 2, "cpu", how, deadline_s=120.0)
    assert time.monotonic() - t0 < 45.0
