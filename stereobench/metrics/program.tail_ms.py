"""Device ms a step inside the program's `d2s.tail` ranges (the fused
tail), or inside `d2s.post` and `d2s.stereo` (the generic tail)."""


def read(run):
    if run.slice is None:
        return None
    fused = run.slice.device_ms_per_range(["d2s.tail"])
    return fused if fused is not None else run.slice.device_ms_per_range(["d2s.post", "d2s.stereo"])
