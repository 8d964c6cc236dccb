"""Command-line tools of the port: `capture_agent` (a desktop's frames into
the pipeline, by shared-memory ring or TCP), `aot_compile` (build the
kernels and warm every stage before a run) and `depth_visualize` (one
image's depth, colormapped).  Nothing is imported here."""
