"""The torch port imports neither JAX nor the JAX package.

A CUDA host need not have JAX, flax, PyYAML, OpenCV, PIL, transformers or
huggingface_hub, so every module of `desktop2stereo_tpu_torch` (and
chip_smoke.py) must import without them: the sources and sinks that need cv2
or PIL import it when they are made, and the converter's jobs import
transformers and huggingface_hub when they run.
Checked in a fresh interpreter, since this test process has JAX loaded.
"""

import os
import pkgutil
import subprocess
import sys

import desktop2stereo_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    pkg = desktop2stereo_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))


def test_port_has_the_slice_modules():
    mods = set(_modules())
    for name in ("core.config", "core.registry", "core.runtime", "ops.normalize",
                 "ops.resize", "ops.activations", "ops.attention", "ops.depth_post",
                 "ops.stereo", "ops.kernels.attention", "ops.kernels.dibr",
                 "ops.kernels.dibr_fill", "ops.kernels.warp", "ops.kernels.build",
                 "ops.quant", "ops.kernels.quant_matmul",
                 "models.dinov2", "models.dpt", "models.depth_anything",
                 "models.factory", "models.from_flax", "models.safetensors_io",
                 "models.convert_hf", "models.vda", "models.da3", "models.dpt_vit",
                 "models.dpt_hybrid", "models.beit", "models.zoedepth", "models.depthpro",
                 "models.infinidepth", "pipeline.programs",
                 "pipeline.engine", "pipeline.metrics", "core.yaml_subset",
                 "core.display", "pipeline.crop", "ops.overlay", "native",
                 "sources", "sources.synthetic", "sources.image", "sources.video",
                 "sources.shm", "sources.screen", "sinks", "sinks.null", "sinks.png",
                 "sinks.video", "sinks.tee", "sinks.mjpeg", "sinks.viewer",
                 "sinks.window", "cli", "sources.net", "sinks.rtmp", "sinks.xr", "xr",
                 "xr.frame_server", "xr.net", "xr.injector", "tools", "tools.capture_agent",
                 "service", "service.control", "pipeline.multi", "pipeline.profiling",
                 "tools.aot_compile", "tools.depth_visualize", "xr.geometry", "xr.filters",
                 "xr.effects", "xr.raster", "xr.glb", "xr.controller_models",
                 "xr.environment", "xr.keyboard", "xr.overlay", "xr.laser", "xr.persist",
                 "xr.theater", "xr.input_map", "xr.input_router", "xr.controls",
                 "xr.session", "xr.gl_theater", "xr.headless_gl", "tools.xr_client",
                 "parallel", "parallel.sharding", "parallel.launch", "parallel.introspect",
                 "tools.convert"):
        assert f"desktop2stereo_tpu_torch.{name}" in mods, name


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'desktop2stereo_tpu', 'yaml', 'cv2', 'PIL',\n"
        " 'transformers', 'huggingface_hub'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
