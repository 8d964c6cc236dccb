"""RTMP/SRT publishing sink through an ffmpeg subprocess.

Port of `desktop2stereo_tpu/sinks/rtmp.py`, the same ffmpeg command line.
The reference builds per-OS ffmpeg capture pipelines of its viewer window
(reference main.py:499-988).  Here the composed frames are already in host
memory, so the pipeline writes raw RGB into ffmpeg's stdin (no window, no
screen grab) and ffmpeg encodes and publishes to the given URL.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import List, Optional

import numpy as np


def detect_audio_source() -> Optional[List[str]]:
    """ffmpeg input args for the system audio monitor, or None.

    The reference records system audio into its macOS RTMP pipeline
    (reference main.py:661-755, avfoundation); the Linux counterparts are
    PulseAudio/PipeWire (`-f pulse -i default` captures the default sink's
    monitor when configured) and ALSA as a last resort."""
    runtime = os.environ.get("XDG_RUNTIME_DIR", "")
    has_pulse = bool(
        shutil.which("pactl")
        or os.path.exists(os.path.join(runtime, "pulse", "native"))
        or os.path.exists(os.path.join(runtime, "pipewire-0"))
    )
    if has_pulse:
        return ["-f", "pulse", "-i", "default"]
    if os.path.exists("/dev/snd"):
        return ["-f", "alsa", "-i", "default"]
    return None


class RtmpSink:
    wants_depth = False

    def __init__(
        self,
        url: str,
        fps: float = 30.0,
        crf: int = 20,
        ffmpeg: Optional[str] = None,
        serve: bool = False,
        mediamtx: Optional[str] = None,
        audio: str = "auto",
        audio_delay: float = 0.0,
    ) -> None:
        """`serve=True` also spawns a local mediamtx media server (if the
        binary is on PATH) so players/headsets can PULL the stream from
        this host over RTMP/RTSP/SRT/HLS — the reference runs the same
        sidecar (reference main.py:993-1017).  Publishing still works
        against any external server when mediamtx is absent.

        `audio`: "auto" captures system audio (pulse/pipewire/alsa) when a
        device is present, "none" disables it, anything else is passed to
        ffmpeg as an explicit pulse device name.  `audio_delay` shifts the
        audio input by N seconds via -itsoffset (the settings 'Audio
        Delay' knob, reference main.py:522,727)."""
        self.url = url
        self.fps = fps
        self.crf = crf
        self.audio_delay = float(audio_delay)
        self._ffmpeg = ffmpeg or shutil.which("ffmpeg")
        if self._ffmpeg is None:
            raise RuntimeError("ffmpeg binary not found; RTMP sink unavailable")
        if audio == "none":
            self.audio_args: Optional[List[str]] = None
        elif audio == "auto":
            self.audio_args = detect_audio_source()
        else:
            self.audio_args = ["-f", "pulse", "-i", audio]
        self._proc: Optional[subprocess.Popen] = None
        self._retry_at = 0.0     # earliest monotonic time to respawn ffmpeg
        self._backoff = 0.5      # doubles per consecutive failure, cap 10 s
        self._fails = 0
        self._shape = None
        self._server: Optional[subprocess.Popen] = None
        if serve:
            path = mediamtx or shutil.which("mediamtx")
            if path is not None:
                self._server = subprocess.Popen(
                    [path], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
                )

    def ffmpeg_argv(self, h: int, w: int) -> List[str]:
        """The ffmpeg command line for an h x w rgb24 stream."""
        fmt = "flv" if self.url.startswith("rtmp") else "mpegts"
        cmd = [
            self._ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{w}x{h}", "-r", str(self.fps), "-i", "-",
        ]
        if self.audio_args:
            if self.audio_delay:
                cmd += ["-itsoffset", str(self.audio_delay)]
            cmd += self.audio_args
        cmd += [
            "-c:v", "libx264", "-preset", "veryfast", "-tune", "zerolatency",
            "-crf", str(self.crf), "-pix_fmt", "yuv420p",
        ]
        if self.audio_args:
            # aac for flv/mpegts; resample to a broadcast-safe rate
            cmd += ["-c:a", "aac", "-b:a", "160k", "-ar", "44100"]
        return cmd + ["-f", fmt, self.url]

    def _start(self, h: int, w: int) -> None:
        self._proc = subprocess.Popen(
            self.ffmpeg_argv(h, w), stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL
        )
        self._shape = (h, w)

    def push(self, sbs_u8: np.ndarray, depth, stats) -> None:
        h, w = sbs_u8.shape[:2]
        if self._proc is None or self._shape != (h, w):
            # restart on resolution change (reference main.py:1018-1061);
            # after a FAILED encoder (publish URL down) back off
            # exponentially instead of forking ffmpeg every frame at 60 Hz
            now = time.monotonic()
            if self._proc is None and now < self._retry_at:
                return  # drop the frame; stream resumes when ffmpeg does
            self.close()
            self._start(h, w)
        try:
            # a byte view of the frame: the pipe takes it without a copy
            self._proc.stdin.write(memoryview(np.ascontiguousarray(sbs_u8)).cast("B"))
            self._backoff = 0.5
        except (BrokenPipeError, ValueError):
            self.close()
            self._retry_at = time.monotonic() + self._backoff
            self._fails += 1
            if self._fails in (1, 10):   # surface once, then once more
                print(f"[rtmp] publish to {self.url} failing "
                      f"(x{self._fails}); retrying with backoff "
                      f"{self._backoff:.1f}s", flush=True)
            self._backoff = min(self._backoff * 2.0, 10.0)

    def close(self) -> None:
        if self._proc is not None:
            try:
                self._proc.stdin.close()
            except Exception:
                pass
            self._proc.terminate()
            try:
                self._proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None

    def shutdown(self) -> None:
        """Full teardown incl. the mediamtx sidecar (close() only recycles
        the encoder so push() can restart it on resolution change)."""
        self.close()
        if self._server is not None:
            self._server.terminate()
            try:
                self._server.wait(timeout=2)
            except subprocess.TimeoutExpired:
                self._server.kill()
            self._server = None
