"""Frame sources: everything that can feed the pipeline.

Port of `desktop2stereo_tpu/sources/`.  Every source has the reference's
grabber interface (`grab() -> BGRA or BGR uint8 frame | None`, reference
capture.py:219).  The synthetic and shared-memory sources need only numpy
and the port's native library; the image source imports PIL, the video
source cv2, and the screen source the native X11 shim, each when it is
made.  The TCP ingest source is not ported yet (ROADMAP A1b).
"""

from desktop2stereo_tpu_torch.sources.synthetic import SyntheticSource  # noqa: F401


def make_source(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticSource(**kw)
    if kind == "image":
        from desktop2stereo_tpu_torch.sources.image import ImageSource

        return ImageSource(**kw)
    if kind == "video":
        from desktop2stereo_tpu_torch.sources.video import VideoSource

        return VideoSource(**kw)
    if kind == "screen":
        from desktop2stereo_tpu_torch.sources.screen import ScreenSource

        return ScreenSource(**kw)
    if kind == "shm":
        from desktop2stereo_tpu_torch.sources.shm import ShmSource

        return ShmSource(**kw)
    if kind == "tcp":
        raise ValueError("the tcp ingest source is not ported to desktop2stereo_tpu_torch "
                         "yet (ROADMAP A1b)")
    raise ValueError(f"unknown source kind {kind!r}")
