"""The 95th percentile of the same population as latency_p50_ms: a tail
of all frames, not a median of chunks."""

from stereobench.window import latencies_ms, percentile


def read(run):
    lat = latencies_ms(((d.t0, d.t) for d in run.deliveries), *run.window)
    return percentile(lat, 95) if lat else None
