"""MJPEG HTTP streaming sink.

Port of `desktop2stereo_tpu/sinks/mjpeg.py`.  cv2 encodes the JPEGs; it is
imported when the sink is made (so the package imports without it) and a
host without it fails there, not in the encoder thread.

Same capability as the reference's MJPEGStreamer (reference streamer.py:
threaded WSGI server, encoder thread JPEG-encoding the latest frame,
multipart/x-mixed-replace paced to FPS, connection cap, HTML canvas client),
written fresh on http.server: an encoder thread compresses only the newest
frame (latest-wins, like the rest of the pipeline) and each client connection
replays the latest JPEG at its own pace.
"""

from __future__ import annotations

import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = b"""<!doctype html><html><head><title>desktop2stereo-tpu</title>
<style>html,body{margin:0;background:#000;height:100%}img{width:100%;height:100%;object-fit:contain}</style>
</head><body><img src="/stream"></body></html>"""


class MjpegSink:
    # engine skips the device->host depth fetch for sinks that never read it
    wants_depth = False

    def __init__(
        self,
        port: int = 1122,
        fps: float = 60.0,
        quality: int = 90,
        max_connections: int = 10,
        host: str = "0.0.0.0",
        show_fps: bool = False,
    ) -> None:
        self.port = port
        self.fps = fps
        self.quality = int(quality)
        self.show_fps = show_fps
        import cv2  # the JPEG encoder; a host without it fails here

        self._cv2 = cv2
        self._overlay = None
        if show_fps:
            from desktop2stereo_tpu_torch.ops.overlay import FpsOverlay

            self._overlay = FpsOverlay()
        self.max_connections = max_connections
        self._jpeg: Optional[bytes] = None
        self._jpeg_seq = 0
        self._cond = threading.Condition()
        self._latest: Optional[np.ndarray] = None
        self._latest_lock = threading.Lock()
        self._stats: dict = {}
        self._conn_count = 0
        self._conn_lock = threading.Lock()
        self._shutdown = threading.Event()
        # set by the CLI to the live ProgramCache: enables GET /mode?set=…
        # (the HTTP analog of the reference viewer's 1-9 hot-keys,
        # reference viewer.py:2304)
        self.mode_switcher = None

        sink = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send_json(self, code: int, obj) -> None:
                import json as _json

                body = (obj if isinstance(obj, bytes)
                        else _json.dumps(obj).encode())
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _query(self) -> dict:
                from urllib.parse import parse_qs, urlparse

                return parse_qs(urlparse(self.path).query)

            def do_GET(self):  # noqa: N802
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_PAGE)))
                    self.end_headers()
                    self.wfile.write(_PAGE)
                    return
                if self.path.startswith("/mode"):
                    from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES

                    q = self._query()
                    sw = sink.mode_switcher
                    if sw is None:
                        self._send_json(503,
                                        {"error": "no live pipeline attached"})
                    elif "set" in q:
                        try:
                            sw.set_display_mode(q["set"][0])
                            self._send_json(200, {"mode": q["set"][0]})
                        except ValueError as e:
                            self._send_json(400, {"error": str(e)})
                    else:
                        # pending-aware property: reports a just-set mode
                        # before the next frame applies it (like /strength)
                        self._send_json(200, {
                            "mode": sw.display_mode,
                            "available": list(DISPLAY_MODES)})
                    return
                if self.path.startswith("/strength"):
                    # live depth strength (the reference viewer's UP/DOWN/0
                    # keys, reference viewer.py:2321-2329): GET /strength,
                    # ?set=2.5, ?delta=0.5, ?reset=1
                    q = self._query()
                    sw = sink.mode_switcher
                    if sw is None or not hasattr(sw, "set_depth_strength"):
                        self._send_json(503,
                                        {"error": "no live pipeline attached"})
                        return
                    try:
                        if "set" in q:
                            # snap to the key-step grid, as the JAX sink
                            # does (there each distinct strength is a
                            # compiled program variant kept for the
                            # session)
                            v = sw.set_depth_strength(
                                round(float(q["set"][0]) * 2.0) / 2.0)
                        elif "delta" in q:
                            v = sw.adjust_depth_strength(
                                round(float(q["delta"][0]) * 2.0) / 2.0)
                        elif "reset" in q:
                            v = sw.reset_depth_strength()
                        else:
                            v = sw.depth_strength
                        self._send_json(200, {"depth_strength": v})
                    except ValueError as e:
                        self._send_json(400, {"error": str(e)})
                    return
                if self.path.startswith("/feather"):
                    # per-eye edge feathering toggle (the reference viewer's
                    # KEY_B, reference viewer.py:2338): GET /feather,
                    # ?toggle=1
                    q = self._query()
                    sw = sink.mode_switcher
                    if sw is None or not hasattr(sw, "toggle_feather"):
                        self._send_json(503,
                                        {"error": "no live pipeline attached"})
                        return
                    on = (sw.toggle_feather() if "toggle" in q
                          else sw.edge_feather)
                    self._send_json(200, {"edge_feather": bool(on)})
                    return
                if self.path.startswith("/stats"):
                    # FPS / 1%-low / per-stage latency / frame + drop counts
                    # — the reference's title-bar readout as JSON (reference
                    # main.py:1233-1251)
                    self._send_json(200, sink._stats or {})
                    return
                if self.path != "/stream":
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                with sink._conn_lock:
                    if sink._conn_count >= sink.max_connections:
                        self.send_response(503)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    sink._conn_count += 1
                try:
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "multipart/x-mixed-replace; boundary=frame"
                    )
                    self.end_headers()
                    seq = 0
                    interval = 1.0 / sink.fps if sink.fps > 0 else 0.0
                    while not sink._shutdown.is_set():
                        with sink._cond:
                            sink._cond.wait_for(
                                lambda: sink._jpeg_seq > seq or sink._shutdown.is_set(),
                                timeout=1.0,
                            )
                            jpeg, seq = sink._jpeg, sink._jpeg_seq
                        if jpeg is None:
                            continue
                        t0 = time.perf_counter()
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\nContent-Length: "
                            + str(len(jpeg)).encode()
                            + b"\r\n\r\n"
                            + jpeg
                            + b"\r\n"
                        )
                        if interval:
                            dt = interval - (time.perf_counter() - t0)
                            if dt > 0:
                                time.sleep(dt)
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    with sink._conn_lock:
                        sink._conn_count -= 1

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, name="d2s-mjpeg-http", daemon=True
        )
        self._encoder_thread = threading.Thread(
            target=self._encode_loop, name="d2s-mjpeg-enc", daemon=True
        )
        self._server_thread.start()
        self._encoder_thread.start()

    # -- pipeline interface --------------------------------------------------

    def push(self, sbs_u8: np.ndarray, depth, stats) -> None:
        if isinstance(stats, dict):
            self._stats = stats  # served at GET /stats (atomic rebind)
        if self._overlay is not None:
            if isinstance(stats, dict):
                fps = stats.get("fps", 0.0)
            else:
                fps = getattr(stats, "fps", 0.0) if stats is not None else 0.0
            if fps and fps > 0:
                sbs_u8 = np.asarray(self._overlay(sbs_u8, fps))
        with self._latest_lock:
            self._latest = sbs_u8

    def _encode_loop(self) -> None:
        cv2 = self._cv2
        interval = 1.0 / self.fps if self.fps > 0 else 0.0
        last = None
        while not self._shutdown.is_set():
            t0 = time.perf_counter()
            with self._latest_lock:
                frame = self._latest
            if frame is not None and frame is not last:
                last = frame
                ok, buf = cv2.imencode(
                    ".jpg", frame[..., ::-1],  # RGB→BGR for cv2
                    [int(cv2.IMWRITE_JPEG_QUALITY), self.quality],
                )
                if ok:
                    with self._cond:
                        self._jpeg = buf.tobytes()
                        self._jpeg_seq += 1
                        self._cond.notify_all()
            if interval:
                dt = interval - (time.perf_counter() - t0)
                if dt > 0:
                    time.sleep(dt)
            else:
                time.sleep(0.001)

    def close(self) -> None:
        self._shutdown.set()
        with self._cond:
            self._cond.notify_all()
        self._server.shutdown()
        self._server_thread.join(timeout=2)
        self._encoder_thread.join(timeout=2)

    @property
    def url(self) -> str:
        return f"http://{socket.gethostname()}:{self.port}/"
