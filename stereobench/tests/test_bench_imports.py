"""Nothing the harness or the reference loads is JAX, flax or the JAX
package, comparing each module's top-level name (the part before the first
dot) whole; the reference loads nothing of the program either.  Each check
runs in a fresh interpreter, since the test process may hold anything."""

import json
import subprocess
import sys

from stereobench.tests.bench_helpers import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
HARNESS = """
from stereobench import run, harness, check, manifest, record, trace, traffic, weights, window
from stereobench import calibrate
import desktop2stereo_tpu_torch.pipeline.multi, desktop2stereo_tpu_torch.pipeline.engine
import desktop2stereo_tpu_torch.models.factory, desktop2stereo_tpu_torch.ops.kernels.build
from stereobench.manifest import ROOT, load_manifest, metric_reader, family
bench = load_manifest(ROOT)
for m in bench["end_to_end"] + bench["per_layer"]:
    metric_reader(m["name"], ROOT)
for c in bench["configs"]:
    family(json.load(open(ROOT / c["file"])), ROOT)
"""
REFERENCE = """
import importlib, pkgutil, stereobench.reference as r
for m in pkgutil.iter_modules(r.__path__):
    importlib.import_module("stereobench.reference." + m.name)
"""


def _top_level(imports):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "desktop2stereo_tpu_torch" in names and "stereobench" in names
    assert not names & {"jax", "jaxlib", "flax", "desktop2stereo_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "desktop2stereo_tpu", "desktop2stereo_tpu_torch"}


def test_the_port_name_is_not_mistaken_for_the_jax_package():
    from stereobench.run import FORBIDDEN, forbidden_modules

    assert "desktop2stereo_tpu_torch".split(".")[0] not in FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["desktop2stereo_tpu_torch.x"] = sys
        before = forbidden_modules()
        sys.modules["desktop2stereo_tpu.models"] = sys
        assert "desktop2stereo_tpu.models" in forbidden_modules()
        assert "desktop2stereo_tpu_torch.x" not in before
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
