"""Checkpoint ingestion in the port, against the JAX package's.

A real-shape (ViT-S: 384/12/6/1536) HF `DepthAnythingForDepthEstimation`
with seeded random weights is saved as safetensors, as one file and sharded
with an index, exactly like a converted HF download (the fixture of
`tests/test_checkpoint_ingestion.py`); a Video-Depth-Anything-Small
checkpoint in the original naming comes from `synth_state_dict` of
`tests/test_models_vda.py`.  The port's `build_bound(..., checkpoint=path)`
must hold exactly the state_dict that `from_flax` makes of the JAX
converter's tree, its depth must match the JAX `build_model` on the same
file, `find_checkpoint` must pick the same file as the JAX one in every
layout, and the CLI must take `--checkpoint`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.models.factory as J_factory
import desktop2stereo_tpu_torch.cli as T_cli
import desktop2stereo_tpu_torch.models.factory as T_factory
from desktop2stereo_tpu.core.registry import get_spec as J_get_spec
from desktop2stereo_tpu.models import convert_hf as J_convert
from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.models import safetensors_io
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.ops.quant import quantize_state_dict
from test_models_vda import synth_state_dict
from torch_threads import one_torch_thread  # noqa: F401

MODEL = "Depth-Anything-V2-Small"
VDA = "Video-Depth-Anything-Small"
REL_TOL = 5e-4  # f32 parity, as tests/test_torch_models.py


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.fixture(scope="module")
def da_checkpoint(tmp_path_factory):
    """{"single": path, "index": path, "shard": path} of one real-shape
    ViT-S Depth-Anything checkpoint."""
    from transformers import DepthAnythingConfig, DepthAnythingForDepthEstimation, Dinov2Config

    spec = get_spec(MODEL)
    hidden, layers, heads, mlp = spec.dims
    bb = Dinov2Config(
        hidden_size=hidden, num_hidden_layers=layers, num_attention_heads=heads,
        intermediate_size=mlp, patch_size=spec.patch_size, image_size=518,
        out_indices=[i + 1 for i in spec.dpt_layers], apply_layernorm=True,
        reshape_hidden_states=False)
    cfg = DepthAnythingConfig(
        backbone_config=bb, fusion_hidden_size=spec.fusion_channels,
        patch_size=spec.patch_size, reassemble_hidden_size=hidden,
        neck_hidden_sizes=list(spec.neck_channels), head_hidden_size=32,
        depth_estimation_type="relative")
    torch.manual_seed(3)
    state = {k: v.contiguous().numpy()
             for k, v in DepthAnythingForDepthEstimation(cfg).eval().state_dict().items()}
    root = tmp_path_factory.mktemp("da_ckpt")
    (root / "single").mkdir()
    (root / "sharded").mkdir()
    single = root / "single" / "model.safetensors"
    safetensors_io.save_file(state, single)
    index = safetensors_io.save_sharded(state, root / "sharded", shards=3)
    return {"single": str(single), "index": index,
            "shard": str(root / "sharded" / "model-00002-of-00003.safetensors")}


@pytest.fixture(scope="module")
def vda_checkpoint(tmp_path_factory):
    """A Video-Depth-Anything-Small checkpoint (original naming) as F16, and
    the same weights nested under "model." as some releases ship them."""
    sd = {k: v.astype(np.float16) for k, v in synth_state_dict(np.random.default_rng(5)).items()}
    root = tmp_path_factory.mktemp("vda_ckpt")
    safetensors_io.save_file(sd, root / "vda.safetensors")
    safetensors_io.save_file({"model." + k: v for k, v in sd.items()}, root / "nested.safetensors")
    return str(root / "vda.safetensors"), str(root / "nested.safetensors")


@pytest.fixture(scope="module")
def da_port(da_checkpoint):
    model, _ = T_factory.build_bound(MODEL, device="cpu", checkpoint=da_checkpoint["single"])
    return model


@pytest.mark.parametrize("layout", ["single", "index", "shard"])
def test_checkpoint_state_dict_equals_from_flax_of_the_jax_tree(da_checkpoint, da_port, layout):
    path = da_checkpoint[layout]
    want = from_flax(J_convert.convert_depth_anything(path, J_get_spec(MODEL)))
    got = (da_port if layout == "single" else
           T_factory.build_bound(MODEL, device="cpu", checkpoint=path)[0]).state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_depth_matches_jax_build_model(da_checkpoint, da_port):
    apply_fn, params, _ = J_factory.build_model(MODEL, checkpoint=da_checkpoint["single"])
    x = np.random.default_rng(11).standard_normal((1, 126, 154, 3)).astype(np.float32)
    want = np.asarray(apply_fn(params, jnp.asarray(x)))
    with torch.no_grad():
        got = da_port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 126, 154)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("nested", [False, True], ids=["pretrained", "model-prefix"])
def test_vda_checkpoint_equals_from_flax_of_the_jax_tree(vda_checkpoint, nested):
    path = vda_checkpoint[nested]
    want = from_flax(J_convert.convert_vda(path, J_get_spec(VDA)))
    got = T_factory.build_bound(VDA, device="cpu", checkpoint=path)[0].state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the head's conv-transposes keep the (C, O, f, f) layout
    sd = safetensors_io.load_file(vda_checkpoint[0])
    np.testing.assert_array_equal(got["head.reassemble.0.resize.weight"].numpy(),
                                  sd["head.resize_layers.0.weight"].astype(np.float32))


def test_int8_from_a_checkpoint_quantizes_the_float_load(da_checkpoint, da_port):
    q, _ = T_factory.build_bound(MODEL, device="cpu", quant="int8",
                                 checkpoint=da_checkpoint["index"])
    want = quantize_state_dict(da_port.state_dict())
    got = q.state_dict()
    assert set(got) == set(want) and any(k.endswith("weight_q") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\0" * 8)
    return str(path)


@pytest.mark.parametrize("layout", ["repo-dir", "flat", "sharded-dir", "hf-hub", "none"])
def test_find_checkpoint_agrees_with_jax(tmp_path, monkeypatch, layout):
    models, hf = tmp_path / "models", tmp_path / "hf"
    for fac in (J_factory, T_factory):
        monkeypatch.setattr(fac, "DEFAULT_WEIGHTS_DIRS", (str(models), str(tmp_path / "cache")))
    monkeypatch.setenv("HF_HOME", str(hf))
    spec = get_spec(VDA)
    repo = spec.hf_repo.replace("/", "--")
    want = {
        "repo-dir": lambda: _touch(models / repo / "model.safetensors"),
        "flat": lambda: _touch(models / f"{VDA}.safetensors"),
        "sharded-dir": lambda: [_touch(models / VDA / f"model-0000{i}-of-00002.safetensors")
                                for i in (1, 2)][0],
        "hf-hub": lambda: _touch(hf / "hub" / f"models--{repo}" / "snapshots" / "abc123"
                                 / "model.safetensors"),
        "none": lambda: None,
    }[layout]()
    # a sharded directory with its index: the index wins
    if layout == "sharded-dir":
        assert T_factory.find_checkpoint(spec) == J_factory.find_checkpoint(J_get_spec(VDA)) == want
        want = _touch(models / VDA / "model.safetensors.index.json")
    assert T_factory.find_checkpoint(spec) == J_factory.find_checkpoint(J_get_spec(VDA)) == want


def test_build_bound_finds_a_cached_checkpoint(da_checkpoint, da_port, monkeypatch, capsys):
    cache = os.path.dirname(os.path.dirname(da_checkpoint["single"]))
    os.makedirs(os.path.join(cache, MODEL), exist_ok=True)
    link = os.path.join(cache, MODEL, "model.safetensors")
    if not os.path.exists(link):
        os.symlink(da_checkpoint["single"], link)
    monkeypatch.setattr(T_factory, "DEFAULT_WEIGHTS_DIRS", (cache,))
    model, _ = T_factory.build_bound(MODEL, device="cpu")
    assert "no checkpoint found" not in capsys.readouterr().out
    w = "backbone.layer.7.mlp.fc2.weight"
    assert torch.equal(model.state_dict()[w], da_port.state_dict()[w])


def test_missing_checkpoint_is_an_error_not_a_random_init(tmp_path):
    with pytest.raises(FileNotFoundError, match="absent.safetensors"):
        T_factory.build_bound(MODEL, device="cpu", checkpoint=str(tmp_path / "absent.safetensors"))


def _cli_args(tmp_path, *extra):
    return ["--device", "cpu", "--source", "synthetic", "--size", "64x112", "--frames", "2",
            "--sink", "null", "--model", MODEL, "--depth-res", "56",
            "--stop-file", str(tmp_path / "stop.request"), "--stats-every", "0", *extra]


def test_cli_runs_with_a_checkpoint(da_checkpoint, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert T_cli.run(_cli_args(tmp_path, "--checkpoint", da_checkpoint["index"])) == 0
    out = capsys.readouterr().out
    assert "[d2s] done:" in out and "no checkpoint found" not in out


def test_cli_without_a_checkpoint_prints_the_random_init_line(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(T_factory, "DEFAULT_WEIGHTS_DIRS", (str(tmp_path / "models"),))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert T_cli.run(_cli_args(tmp_path)) == 0
    assert f"[models] no checkpoint found for {MODEL}; using random init" in capsys.readouterr().out


def test_cli_exits_naming_a_missing_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="absent.safetensors"):
        T_cli.run(_cli_args(tmp_path, "--checkpoint", str(tmp_path / "absent.safetensors")))
