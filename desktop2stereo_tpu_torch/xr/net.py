"""Network transport for the XR frame server: pipeline host → workstation
client.

Port of `desktop2stereo_tpu/xr/net.py`, the same bytes on the wire, so the
JAX package's client reads the port's server and the other way round.  The
reference delivers frames to the headset through same-machine GPU interop
(reference xr_viewer/d3d11_backend.py, frame.py); where the card sits in a
server, the XR runtime lives on a remote workstation and the delivery layer
is a socket: a small length-prefixed TCP protocol around
`xr.frame_server.FrameServer` with its latest-wins semantics.  A client asks
for "anything newer than seq N" and blocks briefly; a slow client skips
frames instead of queueing them.

Wire format (little-endian u32 lengths):
    request : one JSON line  {"last_seen": int, "timeout": float,
                              "encoding": "raw" | "jpeg"}\n
              or the session-config query  {"meta": true}\n
              or the input channel  {"input": [event, ...]}\n: the
              client→host half of the reference's drive-the-desktop loop
              (reference xr_viewer/input.py:121-390), handled by the
              server's `on_input` callback (normally `xr/injector.py`
              InputBridge → XTest) and acked with {"ok": bool}
    response: [u32 header_len][header JSON][u32 rgb_len][rgb bytes]
              [u32 depth_len][depth bytes]
    header  : {"seq", "timestamp", "h", "w", "encoding", "depth": bool,
               "depth_encoding": "none" | "zu16", "dh", "dw"}
              (dh/dw are the depth map's own dims: depth rides at model
              resolution while rgb is the composed frame)
              (meta query: {"meta": {...}} with both payloads empty)
    rgb     : raw HxWx3 u8, or a JPEG (quality 90)
    depth   : zlib-compressed u16 quantization of [0,1] (÷65535), or absent

The meta dict carries the server's settings-derived session config (ipd,
depth_strength, convergence, environment/controller model) so a client
left at defaults renders with the stereo parameters the settings file
prescribes (reference utils.py:851-852, 1070-1071).  A poll with no new
frame returns header {"seq": last_seen} and empty payloads.  "jpeg" needs
cv2, imported when a frame is encoded or decoded.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from desktop2stereo_tpu_torch.sources.net import _read_exact as _recv_exact
from desktop2stereo_tpu_torch.xr.frame_server import FramePacket, FrameServer

_U32 = struct.Struct("<I")


def _encode_rgb(rgb: np.ndarray, encoding: str) -> tuple:
    """→ (payload, encoding_actually_used).  The used encoding must travel
    in the header: silently shipping raw bytes under a \"jpeg\" label makes
    the client imdecode garbage and crash its poll loop.  A raw payload is a
    byte view of the frame, not a copy."""
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if encoding == "jpeg":
        import cv2

        ok, buf = cv2.imencode(".jpg", rgb[..., ::-1],
                               [int(cv2.IMWRITE_JPEG_QUALITY), 90])
        if ok:
            return buf.tobytes(), "jpeg"
    return memoryview(np.ascontiguousarray(rgb)).cast("B"), "raw"


def _encode_depth(depth: Optional[np.ndarray]) -> bytes:
    if depth is None:
        return b""
    q = np.clip(depth, 0.0, 1.0)
    u16 = (q * 65535.0 + 0.5).astype(np.uint16)
    return zlib.compress(u16.tobytes(), level=1)


def _decode_depth(buf, h: int, w: int) -> Optional[np.ndarray]:
    if buf is None or len(buf) == 0:
        return None
    u16 = np.frombuffer(zlib.decompress(buf), np.uint16).reshape(h, w)
    return u16.astype(np.float32) / 65535.0


def _read_exact(sock: socket.socket, n: int) -> np.ndarray:
    buf = _recv_exact(sock, n)
    if buf is None:
        raise ConnectionError("peer closed")
    return buf


class FrameNetServer:
    """Serves a FrameServer over TCP; one thread per client."""

    def __init__(self, frames: FrameServer, host: str = "0.0.0.0",
                 port: int = 1123, meta: Optional[dict] = None,
                 on_input=None):
        self.frames = frames
        self.meta = dict(meta or {})
        self.on_input = on_input
        self.inputs_received = 0
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def setup(self) -> None:
                super().setup()
                # a response goes out in a few writes (the frame unbuffered)
                self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

            def handle(self) -> None:
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError:
                        return
                    if isinstance(req.get("input"), list):
                        events = req["input"]
                        outer.inputs_received += len(events)
                        ok = outer.on_input is not None
                        if ok:
                            try:
                                outer.on_input(events)
                            except Exception:
                                ok = False
                        header = json.dumps({"ok": ok}).encode()
                        self.wfile.write(_U32.pack(len(header)) + header
                                         + _U32.pack(0) + _U32.pack(0))
                        self.wfile.flush()
                        continue
                    if req.get("meta"):
                        header = json.dumps({"meta": outer.meta}).encode()
                        self.wfile.write(_U32.pack(len(header)) + header
                                         + _U32.pack(0) + _U32.pack(0))
                        self.wfile.flush()
                        continue
                    last = int(req.get("last_seen", -1))
                    timeout = float(req.get("timeout", 1.0))
                    enc = req.get("encoding", "raw")
                    pkt = outer.frames.latest(last_seen=last, timeout=timeout)
                    for part in outer._serialize(pkt, last, enc):
                        self.wfile.write(part)
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="d2s-xr-net", daemon=True)

    @staticmethod
    def _serialize(pkt: Optional[FramePacket], last_seen: int, encoding: str) -> list:
        """The response as a list of buffers, written in turn: the frame goes
        out from its own memory, not copied into one response."""
        if pkt is None:
            header = json.dumps({"seq": last_seen}).encode()
            return [_U32.pack(len(header)) + header + _U32.pack(0) + _U32.pack(0)]
        rgb_b, used_enc = _encode_rgb(pkt.rgb, encoding)
        dep_b = _encode_depth(pkt.depth)
        hdr = {
            "seq": pkt.seq, "timestamp": pkt.timestamp,
            "h": int(pkt.rgb.shape[0]), "w": int(pkt.rgb.shape[1]),
            "encoding": used_enc,
            "depth": pkt.depth is not None,
            "depth_encoding": "zu16" if pkt.depth is not None else "none",
        }
        if pkt.depth is not None:
            hdr["dh"] = int(pkt.depth.shape[0])
            hdr["dw"] = int(pkt.depth.shape[1])
        header = json.dumps(hdr).encode()
        return [_U32.pack(len(header)) + header + _U32.pack(len(rgb_b)), rgb_b,
                _U32.pack(len(dep_b)) + dep_b]

    def start(self) -> "FrameNetServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class FrameNetClient:
    """Blocking poll client for workstation XR viewers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1123,
                 encoding: str = "raw"):
        self.encoding = encoding
        self._sock = socket.create_connection((host, port), timeout=10.0)
        self._file = self._sock.makefile("rwb")
        self.last_seen = -1

    def _roundtrip(self, req: dict):
        self._file.write((json.dumps(req) + "\n").encode())
        self._file.flush()
        (hlen,) = _U32.unpack(_read_exact(self._sock, 4))
        header = json.loads(_read_exact(self._sock, hlen).tobytes())
        (rlen,) = _U32.unpack(_read_exact(self._sock, 4))
        rgb_b = _read_exact(self._sock, rlen) if rlen else None
        (dlen,) = _U32.unpack(_read_exact(self._sock, 4))
        dep_b = _read_exact(self._sock, dlen) if dlen else None
        return header, rgb_b, dep_b

    def meta(self) -> dict:
        """Server session config (settings-derived stereo params)."""
        header, _, _ = self._roundtrip({"meta": True})
        return header.get("meta", {}) or {}

    def send_input(self, events: list) -> bool:
        """Ship OS-input events to the capture host (client→server half of
        the reference's in-headset desktop control).  Returns the server's
        ack — False when the host has no injector wired."""
        if not events:
            return True
        header, _, _ = self._roundtrip({"input": list(events)})
        return bool(header.get("ok"))

    def poll(self, timeout: float = 1.0) -> Optional[FramePacket]:
        """Newest frame newer than the last one seen, or None."""
        header, rgb_b, dep_b = self._roundtrip(
            {"last_seen": self.last_seen, "timeout": timeout,
             "encoding": self.encoding})
        if rgb_b is None:
            return None
        h, w = header["h"], header["w"]
        if header.get("encoding") == "jpeg":
            import cv2

            dec = cv2.imdecode(rgb_b, cv2.IMREAD_COLOR)
            if dec is None:   # corrupt/truncated jpeg: skip, don't crash
                return None   # the poll loop (the next frame supersedes it)
            rgb = dec[..., ::-1]
        else:
            rgb = rgb_b.reshape(h, w, 3)
        depth = _decode_depth(dep_b, int(header.get("dh", h)),
                              int(header.get("dw", w)))
        self.last_seen = int(header["seq"])
        return FramePacket(rgb, depth, self.last_seen,
                           float(header.get("timestamp", 0.0)))

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            self._sock.close()
