"""The port's build-and-warm and depth-visualize tools
(`tools/aot_compile.py`, `tools/depth_visualize.py`) on the CPU: each runs
a tiny Depth-Anything to the end with `--device cpu`, and depth_visualize
prints the JAX tool's min/max/mean on the same image and weights (within
5e-3, the pipeline test's depth tolerance) and uses its colormap (equal).
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import desktop2stereo_tpu.core.runtime as J_runtime
import desktop2stereo_tpu.models.factory as J_factory
import desktop2stereo_tpu.pipeline.programs as J_programs
import desktop2stereo_tpu.tools.depth_visualize as J_vis
import desktop2stereo_tpu_torch.models.factory as T_factory
from desktop2stereo_tpu.core.registry import ModelSpec as JSpec
from desktop2stereo_tpu.models.depth_anything import DepthAnything as JDepthAnything
from desktop2stereo_tpu_torch.core.registry import ModelSpec as TSpec
from desktop2stereo_tpu_torch.models.depth_anything import DepthAnything
from desktop2stereo_tpu_torch.models.from_flax import from_flax
from desktop2stereo_tpu_torch.tools import aot_compile, depth_visualize
from test_torch_pipeline import SPEC, TINY, _seeded_params
from torch_threads import one_torch_thread  # noqa: F401

DEPTH_TOL = 5e-3


@pytest.fixture(scope="module")
def weights():
    params = _seeded_params(JDepthAnything(**TINY), jnp.zeros((1, 28, 42, 3), jnp.float32))
    model = DepthAnything(**TINY).eval()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return params, model


@pytest.fixture
def tiny_port(monkeypatch, weights):
    calls = []

    def build(name, device=None, dtype=None, seed=0, quant="none", checkpoint=None):
        calls.append((name, str(device), dtype, quant))
        return weights[1], TSpec(**SPEC)

    monkeypatch.setattr(T_factory, "build_bound", build)
    return calls


def test_aot_compile_warms_each_shape_on_the_cpu(tiny_port, capsys):
    rc = aot_compile.main(["--device", "cpu", "--model", "Depth-Anything-V2-Small",
                           "--depth-res", "56", "--shapes", "64x112,72x128",
                           "--output-resolution", "64", "--display-mode", "Full-SBS"])
    out = capsys.readouterr().out
    assert rc == 0 and tiny_port == [("Depth-Anything-V2-Small", "cpu", torch.float32, "none")]
    assert "nothing to build" in out and "[aot] done" in out
    # each shape's warm line with the generic tail's stages
    for shape in ("64x112", "72x128"):
        assert re.search(rf"\[aot\] {shape}: warm in [0-9.]+s \(pre [0-9.]+s, model [0-9.]+s, "
                         rf"post [0-9.]+s, stereo [0-9.]+s\)", out), out


def _image(path, h=90, w=160):
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([128 + 100 * np.sin(xx / 11.0), 128 + 100 * np.cos(yy / 7.0),
                    128 + 60 * np.sin((xx + yy) / 13.0)], axis=-1)
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(path)


def _stats(out):
    m = re.search(r"shape=\((\d+), (\d+)\) min=([-0-9.]+) max=([-0-9.]+) mean=([-0-9.]+)", out)
    assert m, out
    return tuple(int(v) for v in m.groups()[:2]), np.array([float(v) for v in m.groups()[2:]])


def test_depth_visualize_matches_the_jax_tool(tmp_path, monkeypatch, capsys, weights,
                                              tiny_port):
    img = tmp_path / "frame.png"
    _image(img)
    # the JAX tool on the CPU (f32 there), with the same weights
    monkeypatch.setattr(J_runtime, "setup_compilation_cache", lambda *a: "")
    monkeypatch.setattr(J_factory, "build_bound", lambda name, **kw: (
        J_programs.BoundModel.stateless(JDepthAnything(**TINY).apply, weights[0]),
        JSpec(**SPEC)))
    monkeypatch.setattr(sys, "argv", ["d2s-depth-visualize", str(img), "--depth-res", "56",
                                      "--out", str(tmp_path / "jax" / "v")])
    J_vis.main()
    j_shape, j_stats = _stats(capsys.readouterr().out)
    depth_visualize.main([str(img), "--depth-res", "56", "--device", "cpu", "--sbs",
                          "--out", str(tmp_path / "port" / "v")])
    out = capsys.readouterr().out
    t_shape, t_stats = _stats(out)
    assert t_shape == j_shape == (90, 160)
    np.testing.assert_allclose(t_stats, j_stats, atol=DEPTH_TOL, rtol=0)
    assert (tmp_path / "port" / "v_depth.png").exists() and (tmp_path / "port" / "v_sbs.png").exists()
    assert tiny_port[0][1] == "cpu"


def test_colormap_equals_the_jax_tool():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (17, 23)).astype(np.float32)
    np.testing.assert_array_equal(depth_visualize.colormap_spectral_r(x),
                                  J_vis.colormap_spectral_r(x))
