"""Tee sink: fan one frame stream out to several sinks.

Port of `desktop2stereo_tpu/sinks/tee.py`.

The reference can present AND stream at once (XR with a flat preview
window, reference implementation.py XR_PREVIEW_WINDOW utils.py:1072; the
viewer feeding the MJPEG/RTMP streamers, main.py:1164-1167, 1259) — here
that composes as a tee over the common push() interface.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class TeeSink:
    def __init__(self, sinks: Sequence):
        if not sinks:
            raise ValueError("TeeSink needs at least one sink")
        self.sinks = list(sinks)

    @property
    def wants_depth(self) -> bool:
        # the engine must fetch depth iff any member consumes it
        return any(getattr(s, "wants_depth", True) for s in self.sinks)

    @property
    def url(self) -> Optional[str]:
        urls = [s.url for s in self.sinks if getattr(s, "url", None)]
        return " + ".join(urls) if urls else None

    # the engine wires live display-mode switching onto the sink when the
    # sink supports it; a tee supports it iff any member does
    @property
    def mode_switcher(self):
        for s in self.sinks:
            if getattr(s, "mode_switcher", None) is not None:
                return s.mode_switcher
        return None

    @mode_switcher.setter
    def mode_switcher(self, value) -> None:
        for s in self.sinks:
            if hasattr(s, "mode_switcher"):
                s.mode_switcher = value

    def push(self, sbs_u8: np.ndarray, depth, stats: dict) -> None:
        err: Optional[BaseException] = None
        for s in self.sinks:
            try:
                s.push(sbs_u8, depth, stats)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # keep feeding the other sinks, then surface the failure so
                # the engine's error path sees it (a window close must still
                # stop the run even when a streamer rides alongside)
                err = err or e
        if err is not None:
            raise err

    def close(self) -> None:
        for s in self.sinks:
            try:
                s.close()
            except Exception:
                pass

    def shutdown(self) -> None:
        for s in self.sinks:
            fn = getattr(s, "shutdown", None) or getattr(s, "close", None)
            try:
                if fn:
                    fn()
            except Exception:
                pass
