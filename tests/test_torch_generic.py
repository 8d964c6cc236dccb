"""The generic stereo tail in every display mode at high quality: the port's
ProgramCache against the JAX package's, on the CPU in f32, with the JAX
side on its TPU dispatch (see test_torch_pipeline.py, whose helpers this
file shares).  Half-SBS and Half-TAB take the fused branch on both sides.
The JAX side is one ProgramCache switched live from mode to mode.
"""

import pytest

from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES
from test_torch_pipeline import (  # noqa: F401
    _check_generic_case, jax_caches, jax_kernels, tiny)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", DISPLAY_MODES)
def test_high_quality_mode_matches_jax(tiny, jax_kernels, jax_caches, mode):  # noqa: F811
    kernel = {"Half-SBS": "dibr_render_pair_planar", "Half-TAB": "dibr_render_pair_planar",
              "Depth": None}.get(mode, "dibr_render_pair")  # the colormap runs no kernel
    _check_generic_case(tiny, jax_kernels, jax_caches, mode, "high", {}, (180, 320), kernel)
