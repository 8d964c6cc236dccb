"""Device ms a step of the kernels inside the program's `d2s.model`
ranges, in the traced slice."""


def read(run):
    return None if run.slice is None else run.slice.device_ms_per_range(["d2s.model"])
