"""XR: the host half that serves frames to a headset client, and the
client half that renders them (reference xr_viewer/).

Port of `desktop2stereo_tpu/xr/`.  Serving side: frame_server (the
latest-frame mailbox a client polls), net (the TCP frame protocol with the
meta query and the input channel), injector (OS input injection behind
that channel).  Client side, run by `tools/xr_client.py`: geometry and
filters (screen pose, OneEuro smoothing), effects (frame-derived light terms
as torch ops on the frame's device), the theater and its numpy rasterizer
(raster, glb, environment, controller_models, keyboard, overlay, laser),
the headset's input and session state machines (input_map, input_router,
controls, session), persist, and the OpenGL backends (gl_theater,
headless_gl).
"""

from desktop2stereo_tpu_torch.xr.filters import OneEuroFilter, OneEuroFilter3D, slerp
from desktop2stereo_tpu_torch.xr.frame_server import FrameServer
from desktop2stereo_tpu_torch.xr.geometry import SCREEN_PRESETS, ScreenPose

__all__ = [
    "OneEuroFilter",
    "OneEuroFilter3D",
    "slerp",
    "FrameServer",
    "ScreenPose",
    "SCREEN_PRESETS",
]
