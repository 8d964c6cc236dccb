"""Output sinks: where composed stereo frames go.

Port of `desktop2stereo_tpu/sinks/`.  Every sink has `push(sbs_u8, depth,
stats)` (the reference's `StereoWindow.update_frame`, reference
viewer.py:2359) and says with `wants_depth` whether `FrameEngine` should copy
the depth back.  The null, tee and xr sinks need nothing beyond numpy (xr
imports cv2 only for a client asking for JPEG); png imports PIL, mjpeg,
viewer, video and window import cv2, each when it is made or first writes,
and rtmp runs an ffmpeg binary.
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
    if kind == "rtmp":
        from desktop2stereo_tpu_torch.sinks.rtmp import RtmpSink

        return RtmpSink(**kw)
    if kind == "xr":
        from desktop2stereo_tpu_torch.sinks.xr import XrSink

        return XrSink(**kw)
    raise ValueError(f"unknown sink kind {kind!r}")
