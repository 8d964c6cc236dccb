"""Network frame ingest: a remote desktop feeds the pipeline over TCP.

Port of `desktop2stereo_tpu/sources/net.py`, byte for byte on the wire, so
the JAX package's capture agent feeds the port's source and the port's
agent (`desktop2stereo_tpu_torch.tools.capture_agent`) feeds the JAX
source.  The pipeline listens (`--source tcp:PORT`), a capture agent on the
desktop connects and pushes frames (`--connect HOST:PORT`), and delivery is
latest-wins: if the pipeline is slower than the stream, intermediate frames
are counted as dropped, never queued (the reference's depth-1 raw_q,
reference main.py:66-68).

Wire protocol (all little-endian):

    handshake  agent → server:  b"D2SF" + u16 version(2) + 16B auth token
        token = sha256(shared secret)/16, all-zeros = open mode; the
        server only grants producer takeover on a constant-time match
    per frame  agent → server:  u32 seq | u16 width | u16 height |
                                u8 channels | u8 flags | u32 payload_len |
                                payload
        flags bit0: payload is zlib-compressed
        flags bit1: payload is JPEG (agent opted in; decoded with cv2)

The server drains the socket at wire speed, so TCP backpressure never paces
the agent down to the pipeline's rate; dropping stale frames here is what
keeps latency bounded (reference main.py:218-224).  The reader receives a
frame straight into its array (raw frames are that array; a zlib frame is a
read-only view of the inflated bytes, which `FrameEngine` copies into its
pinned staging buffer on CUDA, or into a writable array on the CPU).

Stats (`TcpFrameSource.stats()`): ingest fps over the last ~2 s of received
frames, frames received/delivered/dropped, decode errors, and the connected
peer.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Optional

import numpy as np

MAGIC = b"D2SF"
VERSION = 2

_HANDSHAKE = struct.Struct("<4sH16s")       # magic, version, auth token
_FRAME_HDR = struct.Struct("<IHHBBI")       # seq, w, h, channels, flags, len

FLAG_ZLIB = 1
FLAG_JPEG = 2

MAX_PAYLOAD = 3840 * 2160 * 4 + 1024        # one 4K BGRA frame
CONNECT_TIMEOUT_S = 10.0                    # the agent's connect to the pipeline host


def _token_bytes(token) -> bytes:
    """Normalize a passphrase to the 16-byte wire token (sha256/16 —
    any-length secrets, constant wire size).  None/'' → all-zeros = open."""
    if not token:
        return b"\x00" * 16
    import hashlib

    if isinstance(token, str):
        token = token.encode()
    return hashlib.sha256(token).digest()[:16]


def _jpeg_dims(data: bytes):
    """(h, w) from the first SOF marker, or None.  Parsed BEFORE
    cv2.imdecode so a crafted JPEG cannot command a multi-GB allocation
    regardless of what the frame header claims."""
    i, n = 2, len(data)
    if n < 4 or data[0:2] != b"\xff\xd8":
        return None
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = int.from_bytes(data[i + 2:i + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 <= n:
                h = int.from_bytes(data[i + 5:i + 7], "big")
                w = int.from_bytes(data[i + 7:i + 9], "big")
                return h, w
            return None
        i += 2 + seg_len
    return None


def _read_exact(sock: socket.socket, n: int) -> Optional[np.ndarray]:
    """n bytes into a fresh u8 array, or None once the peer closed, the
    connection failed or the socket's timeout ran out.  The kernel writes
    them in place with the GIL released: building the frame out of received
    chunks would copy 33 MB a 4K frame under the GIL, which stalls the
    engine's threads in the same process."""
    buf = np.empty(n, np.uint8)
    view, got = memoryview(buf), 0
    try:
        while got < n:
            k = sock.recv_into(view[got:])
            if not k:
                return None
            got += k
    except OSError:
        return None
    return buf


def _decode_payload(payload, w: int, h: int, channels: int, flags: int) -> np.ndarray:
    """A frame payload (bytes or a u8 array) → the [h, w, channels] frame."""
    expect = w * h * channels
    if expect > MAX_PAYLOAD:
        # the listener is network-facing by design; a crafted header must
        # not be able to command a huge allocation
        raise ValueError(f"{w}x{h}x{channels} exceeds the frame bound")
    if flags & FLAG_JPEG:
        import cv2

        payload = bytes(payload)  # a JPEG is small; the marker walk indexes bytes
        dims = _jpeg_dims(payload)
        if dims != (h, w):
            # checked BEFORE imdecode: the decoder allocates at the
            # JPEG's internal dims, which must match the bounded header
            raise ValueError(f"JPEG SOF dims {dims} != header ({h},{w})")
        arr = cv2.imdecode(np.frombuffer(payload, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise ValueError("JPEG decode failed")
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        if arr.shape[0] != h or arr.shape[1] != w:
            raise ValueError(f"JPEG dims {arr.shape[:2]} != header ({h},{w})")
        if arr.shape[2] != channels:
            # a channel count that contradicts the wire header would flip
            # the shape-keyed program cache / BGRA interpretation mid-stream
            raise ValueError(
                f"JPEG channels {arr.shape[2]} != header {channels}")
        return np.ascontiguousarray(arr)
    if flags & FLAG_ZLIB:
        # bounded inflate: a ~33 MB zlib body expanding 1000:1 must stop at
        # the declared frame size, not OOM the pipeline (decompression bomb)
        d = zlib.decompressobj()
        payload = d.decompress(payload, expect + 1)
    if len(payload) != expect:
        raise ValueError(f"payload {len(payload)} B != {expect} B "
                         f"for {w}x{h}x{channels}")
    return np.frombuffer(payload, np.uint8).reshape(h, w, channels)


class TcpFrameSource:
    """Listening frame source.  One producer at a time: a new connection
    replaces the previous one (the reference re-targets its single grabber
    on display changes, reference capture.py:159-217 — same idea here for
    an agent that restarts)."""

    def __init__(self, port: int, host: str = "0.0.0.0",
                 timeout: Optional[float] = 30.0,
                 max_frames: Optional[int] = None,
                 token: "str | bytes | None" = None):
        self.timeout = timeout  # None: wait for an agent indefinitely
        self.max_frames = max_frames
        # shared-secret gate for the takeover handshake: the listener is
        # network-facing by design (the agent is remote), so without a
        # token ANY reachable host could become the producer.  Set the
        # same secret on both ends (cli: D2S_INGEST_TOKEN / agent:
        # --token); unset = open mode for trusted networks.
        self._token = _token_bytes(token)
        self._delivered = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._latest: Optional[np.ndarray] = None
        self._latest_seq = -1
        self._taken_seq = -1
        self._received = 0
        self._decode_errors = 0
        self._peer: Optional[str] = None
        self._recv_times: deque = deque(maxlen=256)
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(2)
        self.port = self._srv.getsockname()[1]   # resolves port=0
        self._conn_gen = 0
        self._conn: Optional[socket.socket] = None
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="tcp-src-accept")
        self._accept_thread.start()

    # --- ingest side -----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, addr = self._srv.accept()
            except OSError:
                return  # closed
            # takeover happens only AFTER a valid handshake (in _reader):
            # a port scanner / health check connecting here must not kill
            # the active capture stream
            threading.Thread(target=self._reader, args=(conn, addr),
                             daemon=True, name="tcp-src-reader").start()

    def _reader(self, conn: socket.socket, addr) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # handshake must arrive promptly: without a timeout every idle
            # connect (health check, scanner) parks a reader thread in
            # recv() forever — unbounded thread/socket leak on an
            # internet-facing port
            conn.settimeout(10.0)
            hs = _read_exact(conn, _HANDSHAKE.size)
            if hs is None:
                return
            conn.settimeout(None)  # frames may be sparse; takeover handles
                                   # a truly dead producer
            magic, version, token = _HANDSHAKE.unpack(hs)
            if magic != MAGIC or version != VERSION:
                return
            import hmac

            if not hmac.compare_digest(token, self._token):
                return  # wrong/missing secret — no takeover, no frames
            with self._lock:
                # handshake OK: this connection is now the producer; close
                # the superseded socket so its blocked recv() errors out
                # instead of leaking a thread waiting on a silent peer
                self._conn_gen += 1
                gen = self._conn_gen
                self._peer = f"{addr[0]}:{addr[1]}"
                old, self._conn = getattr(self, "_conn", None), conn
            if old is not None:
                try:
                    old.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            while not self._closed:
                hdr = _read_exact(conn, _FRAME_HDR.size)
                if hdr is None:
                    return
                seq, w, h, channels, flags, plen = _FRAME_HDR.unpack(hdr)
                if plen > MAX_PAYLOAD or channels not in (1, 3, 4):
                    return  # protocol violation — drop the connection
                payload = _read_exact(conn, plen)
                if payload is None:
                    return
                try:
                    frame = _decode_payload(payload, w, h, channels, flags)
                except Exception:
                    with self._lock:
                        self._decode_errors += 1
                    continue
                with self._cond:
                    if gen != self._conn_gen:
                        return  # a newer agent took over mid-decode —
                                # never overwrite its fresher frame
                    self._latest = frame
                    self._latest_seq += 1
                    self._received += 1
                    self._recv_times.append(time.monotonic())
                    self._cond.notify_all()
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # --- source interface ------------------------------------------------
    def grab(self) -> Optional[np.ndarray]:
        """Latest frame not yet delivered; blocks up to `timeout` for a new
        one (a paced remote ticks faster than that or is gone)."""
        if self.max_frames is not None and self._delivered >= self.max_frames:
            return None
        deadline = (None if self.timeout is None
                    else time.monotonic() + self.timeout)
        with self._cond:
            while self._latest_seq <= self._taken_seq:
                if self._closed:
                    return None
                left = 0.25
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return None
                self._cond.wait(timeout=min(left, 0.25))
            self._taken_seq = self._latest_seq
            self._delivered += 1
            return self._latest

    def stats(self) -> dict:
        with self._lock:
            times = list(self._recv_times)
            recent = [t for t in times if t > time.monotonic() - 2.0]
            fps = 0.0
            if len(recent) >= 2:
                fps = (len(recent) - 1) / max(recent[-1] - recent[0], 1e-6)
            return {
                "ingest_fps": round(fps, 2),
                "frames_received": self._received,
                "frames_delivered": self._delivered,
                "frames_dropped": self._received - self._delivered,
                "decode_errors": self._decode_errors,
                "peer": self._peer,
            }

    def close(self) -> None:
        self._closed = True
        try:
            # shutdown wakes the accept() blocked in the accept thread, which
            # close() alone does not on Linux
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        with self._cond:
            self._cond.notify_all()


class TcpFrameSender:
    """Agent-side producer: connect to the pipeline host and push frames.

    `offer()` is latest-wins at the AGENT: a dedicated sender thread owns
    the socket and always transmits the newest offered frame — when the
    link is slower than the capture rate, stale frames are replaced in the
    depth-1 slot (counted in `skipped`), never queued, and the wire never
    sees a partial frame.  `send()` is the blocking variant (TCP
    backpressure paces a fast agent to the wire) for scripted feeds that
    must deliver every frame."""

    def __init__(self, host: str, port: int,
                 compress: str = "none", jpeg_quality: int = 85,
                 token: "str | bytes | None" = None):
        if compress not in ("none", "zlib", "jpeg"):
            raise ValueError(f"unknown compress mode {compress!r}")
        self._token = _token_bytes(token)
        self.compress = compress
        self.jpeg_quality = int(jpeg_quality)
        self._seq = 0
        self.sent = 0
        self.skipped = 0
        self._slot: Optional[np.ndarray] = None
        self._slot_lock = threading.Lock()
        self._slot_ready = threading.Event()
        self._sender_error: Optional[BaseException] = None
        self._inflight = False
        self._closed = False
        self._sender_thread: Optional[threading.Thread] = None
        self.sock = socket.create_connection((host, port),
                                             timeout=CONNECT_TIMEOUT_S)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(None)
        self.sock.sendall(_HANDSHAKE.pack(MAGIC, VERSION, self._token))

    def _pack(self, frame: np.ndarray) -> bytes:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        h, w = frame.shape[:2]
        channels = 1 if frame.ndim == 2 else frame.shape[2]
        flags = 0
        if self.compress == "jpeg":
            import cv2

            ok, enc = cv2.imencode(
                ".jpg", frame,
                [int(cv2.IMWRITE_JPEG_QUALITY), self.jpeg_quality])
            if not ok:
                raise ValueError("JPEG encode failed")
            payload, flags = enc.tobytes(), FLAG_JPEG
        elif self.compress == "zlib":
            payload, flags = zlib.compress(frame.tobytes(), 1), FLAG_ZLIB
        else:
            payload = frame.tobytes()
        self._seq += 1
        return _FRAME_HDR.pack(self._seq, w, h, channels, flags,
                               len(payload)) + payload

    def send(self, frame: np.ndarray) -> None:
        """Blocking send — every frame is delivered, paced by the link."""
        self.sock.sendall(self._pack(frame))
        self.sent += 1

    def offer(self, frame: np.ndarray) -> None:
        """Latest-wins send: replace whatever is waiting to go out.  The
        sender thread starts on first use; a transport error surfaces on
        the NEXT offer (capture loops poll at frame rate, so the lag is
        one frame)."""
        if self._sender_error is not None:
            raise ConnectionError("sender thread died") from self._sender_error
        if self._sender_thread is None:
            self._sender_thread = threading.Thread(
                target=self._send_loop, daemon=True, name="tcp-sender")
            self._sender_thread.start()
        with self._slot_lock:
            if self._slot is not None:
                self.skipped += 1
            # copy: the capture loop may reuse its buffer for the next grab
            self._slot = np.array(frame, copy=True)
        self._slot_ready.set()

    def _send_loop(self) -> None:
        try:
            while not self._closed:
                if not self._slot_ready.wait(timeout=0.25):
                    continue
                with self._slot_lock:
                    frame, self._slot = self._slot, None
                    self._slot_ready.clear()
                    self._inflight = frame is not None
                if frame is None:
                    continue
                try:
                    self.sock.sendall(self._pack(frame))
                    self.sent += 1
                finally:
                    with self._slot_lock:
                        self._inflight = False
        except BaseException as e:  # surface on next offer()
            if not self._closed:
                self._sender_error = e

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until the pending slot (if any) has gone out."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._slot_lock:
                if (self._slot is None and not self._slot_ready.is_set()
                        and not self._inflight):
                    return True
            if self._sender_error is not None:
                return False
            time.sleep(0.005)
        return False

    def close(self) -> None:
        self._closed = True
        self._slot_ready.set()
        if self._sender_thread is not None:
            self._sender_thread.join(timeout=2.0)
        try:
            self.sock.close()
        except OSError:
            pass
