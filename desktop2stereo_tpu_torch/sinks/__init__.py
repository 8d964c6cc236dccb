"""Output sinks: where composed stereo frames go.

Port of `desktop2stereo_tpu/sinks/`.  Every sink has `push(sbs_u8, depth,
stats)` (the reference's `StereoWindow.update_frame`, reference
viewer.py:2359) and says with `wants_depth` whether `FrameEngine` should copy
the depth back.  The null and tee sinks need nothing beyond numpy; png
imports PIL, and mjpeg, viewer, video and window import cv2, each when it is
made or first writes.  The RTMP and XR sinks are not ported yet (ROADMAP
A1b).
"""

from desktop2stereo_tpu_torch.sinks.null import NullSink  # noqa: F401

SINK_KINDS = ("mjpeg", "png", "video", "null", "rtmp", "viewer", "window", "xr")


def make_sink(kind: str, **kw):
    if kind == "null":
        return NullSink(**kw)
    if kind == "png":
        from desktop2stereo_tpu_torch.sinks.png import PngSink

        return PngSink(**kw)
    if kind == "mjpeg":
        from desktop2stereo_tpu_torch.sinks.mjpeg import MjpegSink

        return MjpegSink(**kw)
    if kind == "video":
        from desktop2stereo_tpu_torch.sinks.video import VideoSink

        return VideoSink(**kw)
    if kind == "viewer":
        from desktop2stereo_tpu_torch.sinks.viewer import StereoWindow

        return StereoWindow(**kw)
    if kind == "window":
        from desktop2stereo_tpu_torch.sinks.window import WindowSink

        return WindowSink(**kw)
    if kind in ("rtmp", "xr"):
        raise ValueError(f"the {kind} sink is not ported to desktop2stereo_tpu_torch yet "
                         f"(ROADMAP A1b)")
    raise ValueError(f"unknown sink kind {kind!r}")
