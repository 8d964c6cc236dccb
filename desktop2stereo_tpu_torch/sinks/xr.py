"""XR sink: publish (rgb, depth) to remote headset clients over TCP.

Port of `desktop2stereo_tpu/sinks/xr.py`.  The reference's OpenXR mode
hands each frame's color and depth to the same-machine viewer for per-eye
DIBR at render time (reference main.py:1282-1318).  Where the card sits in
a server the headset's workstation is remote, so this sink drops frames into
the latest-wins `FrameServer` and serves them through `xr.net`.  It wants
depth: `FrameEngine` copies the model-resolution depth (f32 in [0, 1]) back
with every frame.
"""

from __future__ import annotations

import socket
from typing import Optional

import numpy as np

from desktop2stereo_tpu_torch.xr.frame_server import FrameServer
from desktop2stereo_tpu_torch.xr.net import FrameNetServer


class XrSink:
    wants_depth = True

    def __init__(self, port: int = 1123, host: str = "0.0.0.0",
                 meta: Optional[dict] = None, inject_input: bool = True,
                 injector=None):
        """`meta` is the settings-derived session config advertised to
        clients (ipd/depth_strength/convergence/environment/controller), see
        xr.net's meta query.

        `inject_input` wires the protocol's input channel into an OS
        injector (XTest) so headset clients drive this desktop: the
        reference's in-headset control loop (reference
        xr_viewer/input.py:121-390).  A host without a display serves frames
        only; the url says which."""
        self.frames = FrameServer()
        self.bridge = None
        touch = None
        if injector is None and inject_input:
            from desktop2stereo_tpu_torch.xr.injector import make_injector, make_touch_injector

            injector = make_injector()
            if injector is not None:
                # real multitouch for the two-trigger pinch when the host
                # grants /dev/uinput; the bridge synthesizes ctrl+wheel zoom
                # otherwise
                touch = make_touch_injector(injector.screen_size)
        if injector is not None:
            from desktop2stereo_tpu_torch.xr.injector import InputBridge

            self.bridge = InputBridge(injector, touch_injector=touch)
        self._net = FrameNetServer(
            self.frames, host=host, port=port, meta=meta,
            on_input=self.bridge.handle if self.bridge else None).start()
        self.port = self._net.port
        self.host = host

    @property
    def url(self) -> str:
        # 0.0.0.0 is a bind address, not one a remote client can dial
        host = socket.gethostname() if self.host in ("0.0.0.0", "") else self.host
        inp = "input: XTest" if self.bridge else "input: none (headless)"
        return f"tcp://{host}:{self.port} (xr frame protocol, {inp})"

    def push(self, sbs_u8: np.ndarray, depth: Optional[np.ndarray], stats: dict) -> None:
        self.frames.update_frame(sbs_u8, depth)

    def close(self) -> None:
        self._net.close()
        if self.bridge is not None:
            for inj in (self.bridge.touch_injector, self.bridge.injector):
                if inj is not None:
                    inj.close()  # lifts stuck touches, releases keys
