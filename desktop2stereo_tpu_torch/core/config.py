"""Display modes of the stereo output.

The port's own copy of `desktop2stereo_tpu/core/config.py:DISPLAY_MODES`
(that module needs PyYAML, which a CUDA host need not have).  The order is
the viewer's hot-key cycle order and matters: `ProgramCache.cycle_display_mode`
steps through it.
"""

DISPLAY_MODES = (
    "Half-SBS",
    "Full-SBS",
    "Half-TAB",
    "Full-TAB",
    "Anaglyph",
    "Row-Interleaved",
    "Column-Interleaved",
    "Mono",
    "Depth",
)
