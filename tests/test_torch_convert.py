"""The port's checkpoint tool (tools/convert.py) against the JAX package's.

The port's copy of `tests/test_verify_depth_gate.py`: a real-shape
Depth-Anything-V2-Small snapshot with seeded random weights, made by the
port's own `make_random_snapshot`, goes through `transformers` (the oracle,
f32 on the CPU) and the port's pipeline (`port_depth`, f32 on the CPU) at
depth resolution 126.  Beside the gate: the port's pipeline against the JAX
tool's on the same snapshot, the other jobs (download and the egress probe
with the network calls monkeypatched, reserialize, verify), the parameter
count against JAX's, and the refusal of a job whose package is missing.
Nothing here reaches the network: every test runs with `urlopen` and
`getaddrinfo` replaced.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import socket
import sys
import urllib.request

import numpy as np
import pytest
import torch

from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.models import factory
from desktop2stereo_tpu_torch.models.convert_hf import param_count
from desktop2stereo_tpu_torch.models.safetensors_io import load_checkpoint
from desktop2stereo_tpu_torch.tools import convert
from torch_threads import one_torch_thread  # noqa: F401

MODEL = "Depth-Anything-V2-Small"
RES = 126
REL_TOL = 5e-4  # f32 parity, as tests/test_torch_checkpoint.py
GATE_HEADROOM = 2e-3  # the JAX gate test's bound on rel_err_max (test_verify_depth_gate.py)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Every lookup and request fails here, as on a host without egress."""
    def refuse(*args, **kwargs):
        raise OSError("network access is refused in these tests")

    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """config.json + model.safetensors at ViT-S's real shapes, seed 7."""
    out = convert.make_random_snapshot(MODEL, str(tmp_path_factory.mktemp("hf_snapshot")), seed=7)
    assert os.path.exists(os.path.join(out, "config.json"))
    assert os.path.exists(os.path.join(out, "model.safetensors"))
    return out


@pytest.fixture(scope="module")
def small_image(tmp_path_factory):
    from PIL import Image

    img = np.random.default_rng(21).integers(0, 255, (180, 320, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("image") / "scene.png"
    Image.fromarray(img).save(path)
    return str(path)


def test_gate_passes_on_converted_weights(snapshot, small_image):
    v = convert.verify_depth(MODEL, checkpoint=snapshot, image=small_image,
                             depth_resolution=RES, device="cpu")
    assert v["pass"], f"gate failed: rel_err_max={v['rel_err_max']:.3e}"
    assert v["rel_err_max"] < GATE_HEADROOM
    assert v["device"] == "cpu" and v["checkpoint"].endswith("model.safetensors")
    assert set(v) == {"gate", "model", "checkpoint", "image", "oracle", "depth_resolution",
                      "shape", "rel_err_max", "rel_err_mean", "tol", "pass", "egress", "device"}
    assert v["egress"] == {"huggingface.co": "dns-dead (OSError)",
                           "hf-mirror.com": "dns-dead (OSError)"}


def test_gate_fallback_oracle_without_reference_tree(snapshot, small_image, monkeypatch):
    """Without the reference tree the gate still runs: the raw
    `predicted_depth` of transformers' model against the port's model."""
    monkeypatch.setattr(convert, "REFERENCE_DIR", "/nonexistent/reference")
    v = convert.verify_depth(MODEL, checkpoint=snapshot, image=small_image,
                             depth_resolution=RES, device="cpu")
    assert v["oracle"] == "raw-forward" and v["pass"]
    assert v["shape"] == list(convert_shape(small_image))


@pytest.mark.parametrize("tree", ["none", "assets_only"])
def test_reference_dir_picks_the_image_and_the_oracle(tree, tmp_path, monkeypatch):
    """Without a reference tree the default image is the synthetic 1080p
    scene; with one, its assets/cats.jpg.  The reference oracle is looked
    for only where the tree holds depth.py, and the lookup leaves sys.path
    and the test helpers alone."""
    from PIL import Image

    want = None
    if tree == "none":
        monkeypatch.setattr(convert, "REFERENCE_DIR", None)
    else:
        os.makedirs(tmp_path / "assets")
        want = np.random.default_rng(3).integers(0, 256, (40, 60, 3), dtype=np.uint8)
        # PNG content under the reference's file name: lossless, so exact
        Image.fromarray(want).save(tmp_path / "assets" / "cats.jpg", format="PNG")
        monkeypatch.setattr(convert, "REFERENCE_DIR", str(tmp_path))
    path_before = list(sys.path)
    monkeypatch.delitem(sys.modules, "tests.reference_loader", raising=False)
    img = convert._load_image(None)
    if want is None:
        assert img.shape == (1080, 1920, 3) and img.dtype == np.uint8
        assert np.array_equal(img, convert._load_image(None))
    else:
        assert np.array_equal(img, want)
    assert convert._reference_predict_depth_ns(False, 0.0, 1.0) is None
    assert sys.path == path_before and "tests.reference_loader" not in sys.modules


def convert_shape(path):
    from desktop2stereo_tpu_torch.ops.resize import patch_aligned_size

    img = convert._load_image(path)
    return patch_aligned_size(*img.shape[:2], RES, get_spec(MODEL).patch_size)


def test_gate_fails_on_wrong_weights_and_main_exits_1(snapshot, small_image, monkeypatch,
                                                      capsys):
    """A gate that cannot fail proves nothing: corrupt the port's weights and
    the verdict flips, and the command exits 1."""
    real = factory.build_bound

    def corrupted(name, **kw):
        model, spec = real(name, **kw)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.5).add_(0.01)
        return model, spec

    monkeypatch.setattr(factory, "build_bound", corrupted)
    with pytest.raises(SystemExit) as exit_info:
        convert.main(["--model", MODEL, "--verify-depth", "--checkpoint", snapshot,
                      "--image", small_image, "--depth-res", str(RES), "--device", "cpu"])
    assert exit_info.value.code == 1
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["pass"] is False and verdict["rel_err_max"] > verdict["tol"]


@pytest.mark.parametrize("post", [False, True], ids=["raw", "post"])
def test_port_depth_equals_the_jax_pipeline(snapshot, small_image, post):
    """The port's side of the gate against the JAX tool's side on the same
    snapshot: `factory.build_model(..., checkpoint=)` through JAX's
    `resize_patch_aligned`, `normalize_for_model` and the model (and, with
    the reference oracle's post, `post_process_depth` and the bilinear
    resize back), as JAX's `verify_depth` runs them."""
    import jax.numpy as jnp

    from desktop2stereo_tpu.models import factory as J_factory

    J_post = importlib.import_module("desktop2stereo_tpu.ops.depth_post")
    J_norm = importlib.import_module("desktop2stereo_tpu.ops.normalize")
    J_resize = importlib.import_module("desktop2stereo_tpu.ops.resize")

    ckpt = os.path.join(snapshot, "model.safetensors")
    spec = get_spec(MODEL)
    img = convert._load_image(small_image)
    apply_fn, params, _ = J_factory.build_model(MODEL, checkpoint=ckpt)
    x = jnp.asarray(img, jnp.float32)[None]
    x = J_resize.resize_patch_aligned(x, RES, spec.patch_size) / 255.0
    x = J_norm.normalize_for_model(x, spec.norm_family)
    want = apply_fn(params, x)[0]
    if post:
        want = J_post.post_process_depth(want, metric=spec.metric, foreground_scale=0.0,
                                         aa_strength=1.0)
        want = J_resize.resize(want[..., None], img.shape[:2], mode="bilinear",
                               antialias=False)[..., 0]
    want = np.asarray(want)

    model, _ = factory.build_bound(MODEL, device="cpu", dtype=torch.float32, checkpoint=ckpt)
    got = convert.port_depth(model, spec, img, RES, "cpu", post=post)
    assert got.shape == want.shape == ((180, 320) if post else convert_shape(small_image))
    assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL


def test_download_and_the_probes_match_jax_without_a_network(monkeypatch, capsys):
    """`download` pulls the registry repo through `snapshot_download` at the
    endpoint `pick_endpoint` chose (the mirror where the hub does not
    answer); `probe_egress` records each host as the JAX tool does, and looks
    nothing up under HF_HUB_OFFLINE."""
    import huggingface_hub

    from desktop2stereo_tpu.tools import convert as J_convert

    calls = []

    def fake_snapshot_download(repo, allow_patterns):
        calls.append((repo, list(allow_patterns), os.environ.get("HF_ENDPOINT")))
        return f"/hub/{repo}"

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot_download)
    monkeypatch.setenv("HF_ENDPOINT", "unset")
    monkeypatch.delenv("HF_ENDPOINT")
    assert convert.pick_endpoint() == J_convert.pick_endpoint() == "https://hf-mirror.com"
    path = convert.download(MODEL)
    repo = get_spec(MODEL).hf_repo
    assert path == f"/hub/{repo}"
    assert calls == [(repo, ["*.safetensors", "*.json"], "https://hf-mirror.com")]
    assert f"{repo} -> /hub/{repo}" in capsys.readouterr().out

    monkeypatch.delenv("HF_ENDPOINT")
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: None)
    assert convert.pick_endpoint() == J_convert.pick_endpoint() == "https://huggingface.co"

    def lookup(host, port):
        if host == "hf-mirror.com":
            raise socket.gaierror("no such host")
        return [(socket.AF_INET, socket.SOCK_STREAM, 6, "", ("127.0.0.1", port))]

    monkeypatch.setattr(socket, "getaddrinfo", lookup)
    got = convert.probe_egress()
    assert got == J_convert.probe_egress() == {"huggingface.co": "dns-ok",
                                                "hf-mirror.com": "dns-dead (gaierror)"}
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(socket, "getaddrinfo", None)  # a lookup would raise TypeError
    assert set(convert.probe_egress().values()) == {"not probed (HF_HUB_OFFLINE)"}


def test_reserialize_rewrites_the_snapshot_with_the_same_tensors(snapshot, tmp_path, capsys):
    folder = tmp_path / "model"
    shutil.copytree(snapshot, folder)
    before = {k: v.copy() for k, v in load_checkpoint(folder / "model.safetensors").items()}
    convert.reserialize(str(folder))
    after = load_checkpoint(folder / "model.safetensors")
    assert set(after) == set(before)
    assert all(np.array_equal(after[k], before[k]) for k in before)
    assert "re-serialized" in capsys.readouterr().out


def test_verify_finds_the_hub_snapshot_and_counts_its_parameters(snapshot, tmp_path,
                                                                 monkeypatch, capsys):
    """`--verify` on a hub-cache layout: find_checkpoint reads the snapshot
    under $HF_HOME, the model is built from it, and the count printed is
    JAX's for the same tree."""
    repo = get_spec(MODEL).hf_repo.replace("/", "--")
    snap = tmp_path / "hub" / f"models--{repo}" / "snapshots" / "0"
    snap.mkdir(parents=True)
    shutil.copy(os.path.join(snapshot, "model.safetensors"), snap)
    monkeypatch.setattr(factory, "DEFAULT_WEIGHTS_DIRS", [str(tmp_path / "none")])
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    convert.main(["--model", MODEL, "--verify", "--skip-download", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{snap / 'model.safetensors'} -> 24.7M params OK" in out


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_param_count_equals_jax(quant):
    from desktop2stereo_tpu.models import factory as J_factory
    from desktop2stereo_tpu.models.convert_hf import param_count as J_param_count

    _, params, _ = J_factory.build_model(MODEL, quant=quant)
    model, _ = factory.build_bound(MODEL, device="cpu", quant=quant)
    assert param_count(model) == J_param_count(params)


@pytest.mark.parametrize("job,package", [
    (lambda tmp: convert.make_random_snapshot(MODEL, str(tmp)), "transformers"),
    (lambda tmp: convert.verify_depth(MODEL, checkpoint=str(tmp), device="cpu"), "transformers"),
    (lambda tmp: convert.reserialize(str(tmp)), "transformers"),
    (lambda tmp: convert.download(MODEL), "huggingface_hub"),
], ids=["make-random-snapshot", "verify-depth", "model-path", "download"])
def test_a_job_without_its_package_raises_naming_it(job, package, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, package, None)  # import raises ImportError
    with pytest.raises(ImportError, match=package):
        job(tmp_path)


def test_main_exits_naming_the_missing_package_and_cuda(tmp_path, monkeypatch):
    """On a host without transformers the job's command exits 1 naming
    it, with no fallback.  Without a card, `--device cuda` (the default)
    exits 2 before any job."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit) as exit_info:
        convert.main(["--model", MODEL, "--make-random-snapshot", str(tmp_path),
                      "--device", "cpu"])
    assert "transformers" in str(exit_info.value.code)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        convert.main(["--model", MODEL, "--verify", "--skip-download"])
    assert exit_info.value.code == 2
