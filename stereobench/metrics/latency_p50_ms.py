"""The median, over every frame delivered in the window on every feed, of
its delivery time minus the engine's capture time of that frame."""

from stereobench.window import latencies_ms, percentile


def read(run):
    lat = latencies_ms(((d.t0, d.t) for d in run.deliveries), *run.window)
    return percentile(lat, 50) if lat else None
