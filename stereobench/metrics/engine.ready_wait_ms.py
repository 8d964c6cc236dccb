"""Median ms, over the frames dispatched in the traced slice, from the end
of the device work that the runtime calls inside the frame's `d2s.dispatch`
span started to the start of its `d2s.finish`: how long a frame that the
card has finished waits for the host.  The spans are placed on the trace
by the `d2s.clock` range's offset."""

import statistics

from stereobench import spans as S


def read(run):
    got = S.engine_spans()
    if run.slice is None or got is None:
        return None
    events = run.slice.events
    offset = S.clock_offset_us(events, got[1])
    if offset is None:
        return None
    calls, ends = S.runtime_calls(events), S.device_ends(events)
    starts = [float(e["ts"]) for e in calls]
    waits = []
    for parts in S.frame_parts(got[0]).values():
        _, a, b, _ = parts["d2s.dispatch"]
        a, b = a / 1e3 + offset, b / 1e3 + offset
        if not run.slice.start <= a < run.slice.end:
            continue
        end = S.device_end_us(a, b, calls, starts, ends)
        if end is not None:
            waits.append(parts["d2s.finish"][1] / 1e3 + offset - end)
    return statistics.median(waits) / 1e3 if waits else None
