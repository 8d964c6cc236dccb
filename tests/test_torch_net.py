"""The port's TCP frame ingest (`sources/net.py`) and capture agent
(`tools/capture_agent.py`) against the JAX package on the CPU.

- the wire: protocol constants, token digests and `_pack` bytes equal to
  JAX's for raw, zlib and JPEG frames of 4 and 3 channels; `_decode_payload`
  gives JAX's frames, and its guards (decompression bomb, JPEG SOF dims,
  the frame bound) refuse what JAX's refuse;
- both directions over loopback: JAX's sender into the port's source and
  the port's sender into JAX's source, raw and zlib; a token mismatch
  refused on both sides; JAX's capture agent into the port's source and the
  port's agent into JAX's source, and the port's agent into a ring;
- the port's copy of `tests/test_sources_net.py`, case for case, bounded by
  counts and events (each wait has a generous timeout) rather than by wall
  clock.
"""

import contextlib
import os
import socket
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import desktop2stereo_tpu.native as J_native
import desktop2stereo_tpu.sources.net as J_net
import desktop2stereo_tpu.sources.screen as J_screen
import desktop2stereo_tpu.tools.capture_agent as J_agent
import desktop2stereo_tpu_torch.native as T_native
import desktop2stereo_tpu_torch.sources.net as T_net
import desktop2stereo_tpu_torch.sources.screen as T_screen
import desktop2stereo_tpu_torch.tools.capture_agent as T_agent
from desktop2stereo_tpu_torch.sources.net import FLAG_ZLIB, TcpFrameSender, TcpFrameSource
from torch_threads import one_torch_thread  # noqa: F401

WAIT_S = 60.0  # the bound on every wait below; the checks are on counts and events
NETS = {"jax": J_net, "port": T_net}


def _frame(seed: int, h: int = 24, w: int = 32, c: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (h, w, c), dtype=np.uint8)


def _smooth(h: int = 24, w: int = 32, c: int = 3) -> np.ndarray:
    """A gradient (JPEG's error on noise is unbounded)."""
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [yy * 10, xx * 7, yy * 3 + xx * 2, np.full_like(yy, 255)]
    return np.stack(planes[:c], axis=2).astype(np.uint8)


def _wait(pred, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _grab_until(src, want: np.ndarray) -> list:
    """Grab until `want` is delivered; returns every delivered frame."""
    got = []
    deadline = time.monotonic() + WAIT_S
    while not (got and np.array_equal(got[-1], want)):
        if time.monotonic() > deadline:
            raise AssertionError(f"{len(got)} frames delivered, not the one awaited")
        g = src.grab()
        if g is not None:
            got.append(g)
    return got


def _closed_by_peer(sock) -> bool:
    """Whether the peer closed the connection (FIN, or RST where our bytes
    were left unread)."""
    sock.settimeout(WAIT_S)
    try:
        return sock.recv(1) == b""
    except ConnectionResetError:
        return True


def _close(src) -> None:
    src.close()
    src._accept_thread.join(WAIT_S)
    assert not src._accept_thread.is_alive()


@pytest.fixture
def port_source():
    made = []

    def make(**kw):
        src = TcpFrameSource(port=0, host="127.0.0.1", **{"timeout": 5.0, **kw})
        made.append(src)
        return src

    yield make
    for src in made:
        _close(src)


# ---- the wire against JAX ------------------------------------------------------------


def test_protocol_constants_match_jax():
    for name in ("MAGIC", "VERSION", "FLAG_ZLIB", "FLAG_JPEG", "MAX_PAYLOAD"):
        assert getattr(T_net, name) == getattr(J_net, name), name
    assert T_net._HANDSHAKE.format == J_net._HANDSHAKE.format
    assert T_net._FRAME_HDR.format == J_net._FRAME_HDR.format


@pytest.mark.parametrize("token", [None, "", "s3cret", b"raw-bytes", "ünïcode"])
def test_token_digest_matches_jax(token):
    assert T_net._token_bytes(token) == J_net._token_bytes(token)
    assert len(T_net._token_bytes(token)) == 16


class _Listener:
    """A bare TCP listener: a sender's constructor connects to it."""

    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("compress", ["none", "zlib", "jpeg"])
@pytest.mark.parametrize("channels", [4, 3])
def test_pack_bytes_match_jax(compress, channels):
    lst = _Listener()
    senders = [net.TcpFrameSender("127.0.0.1", lst.port, compress=compress, token="k")
               for net in (J_net, T_net)]
    try:
        for seed in range(3):  # seq advances alike
            f = _smooth(c=channels) if compress == "jpeg" else _frame(seed, c=channels)
            j, t = (s._pack(f) for s in senders)
            assert t == j, (compress, channels, seed)
    finally:
        for s in senders:
            s.close()
        lst.close()


@pytest.mark.parametrize("compress", ["none", "zlib", "jpeg"])
def test_decode_payload_matches_jax(compress):
    f = _smooth(c=3) if compress == "jpeg" else _frame(5, c=4)
    lst = _Listener()
    snd = J_net.TcpFrameSender("127.0.0.1", lst.port, compress=compress)
    try:
        pkt = snd._pack(f)
    finally:
        snd.close()
        lst.close()
    hdr = J_net._FRAME_HDR.unpack(pkt[:J_net._FRAME_HDR.size])
    _, w, h, c, flags, _ = hdr
    payload = pkt[J_net._FRAME_HDR.size:]
    j = J_net._decode_payload(payload, w, h, c, flags)
    t = T_net._decode_payload(payload, w, h, c, flags)
    assert t.dtype == j.dtype == np.uint8 and t.shape == j.shape == f.shape
    np.testing.assert_array_equal(t, j)
    if compress != "jpeg":
        np.testing.assert_array_equal(t, f)


def test_decode_guards_match_jax():
    """The decompression bomb, the JPEG SOF dims and the frame bound are
    refused by both packages before any large allocation."""
    cv2 = pytest.importorskip("cv2")
    bomb = zlib.compress(b"\x00" * (1 << 20), 9)
    ok, enc = cv2.imencode(".jpg", np.zeros((64, 64, 3), np.uint8))
    assert ok
    jpeg = enc.tobytes()
    cases = [
        ((bomb, 16384, 16384, 4, T_net.FLAG_ZLIB), "frame bound"),
        ((bomb, 1000, 1000, 1, T_net.FLAG_ZLIB), "payload"),
        ((jpeg, 1, 1, 3, T_net.FLAG_JPEG), "SOF dims"),
        ((jpeg, 64, 64, 4, T_net.FLAG_JPEG), "channels"),
        ((b"\x00" * 10, 4, 4, 4, 0), "payload"),
    ]
    for args, match in cases:
        for net in (J_net, T_net):
            with pytest.raises(ValueError, match=match):
                net._decode_payload(*args)
    for data in (jpeg, b"\xff\xd8\xff", b"not a jpeg", jpeg[:20]):
        assert T_net._jpeg_dims(data) == J_net._jpeg_dims(data)


@pytest.mark.parametrize("compress", ["none", "zlib"])
@pytest.mark.parametrize("sender,source", [("jax", "port"), ("port", "jax")])
def test_cross_package_stream(sender, source, compress):
    """One package's sender feeds the other's source: every delivered frame
    is a sent one, the last arrives bit-exact, and the stats add up."""
    src = NETS[source].TcpFrameSource(port=0, host="127.0.0.1", timeout=5.0, token="t0k")
    snd = NETS[sender].TcpFrameSender("127.0.0.1", src.port, compress=compress, token="t0k")
    try:
        sent = [_frame(i) for i in range(6)]
        for f in sent:
            snd.send(f)
        got = _grab_until(src, sent[-1])
        for g in got:
            assert any(np.array_equal(g, f) for f in sent)
        _wait(lambda: src.stats()["frames_received"] == len(sent), "every frame received")
        st = src.stats()
        assert st["frames_delivered"] == len(got)
        assert st["frames_dropped"] == len(sent) - len(got)
        assert st["decode_errors"] == 0
    finally:
        snd.close()
        src.close()


@pytest.mark.parametrize("sender,source", [("jax", "port"), ("port", "jax")])
def test_cross_package_token_mismatch_refused(sender, source):
    src = NETS[source].TcpFrameSource(port=0, host="127.0.0.1", timeout=5.0, token="s3cret")
    bad = NETS[sender].TcpFrameSender("127.0.0.1", src.port, token="wrong")
    open_ = NETS[sender].TcpFrameSender("127.0.0.1", src.port)  # no token at all
    good = None
    try:
        for s in (bad, open_):
            try:
                s.send(_frame(1))
            except OSError:
                pass  # the server closed on us: acceptable
        good = NETS[sender].TcpFrameSender("127.0.0.1", src.port, token="s3cret")
        f = _frame(2)
        good.send(f)
        assert np.array_equal(_grab_until(src, f)[0], f)  # the refused frames never landed
        assert src.stats()["frames_received"] == 1
    finally:
        for s in (bad, open_, good):
            if s is not None:
                s.close()
        src.close()


# ---- the capture agents --------------------------------------------------------------


class _FakeScreen:
    """Five distinct frames, then the end of the source (the agent exits)."""
    FRAMES = [_frame(100 + i, 16, 24) for i in range(5)]

    def __init__(self, **kw):
        self.n = 0

    def grab(self):
        self.n += 1
        return self.FRAMES[self.n - 1] if self.n <= len(self.FRAMES) else None

    def close(self):
        pass


@pytest.mark.parametrize("agent,source", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("compress", ["none", "zlib"])
def test_capture_agent_feeds_the_other_package(monkeypatch, agent, source, compress):
    """`capture_agent --connect` of one package into the other's source,
    with the shared secret from D2S_INGEST_TOKEN: the last captured frame
    arrives, and every delivered frame is a captured one."""
    monkeypatch.setenv("D2S_INGEST_TOKEN", "agent-secret")
    monkeypatch.setattr(J_screen, "ScreenSource", _FakeScreen)
    monkeypatch.setattr(T_screen, "ScreenSource", _FakeScreen)
    src = NETS[source].TcpFrameSource(port=0, host="127.0.0.1", timeout=5.0,
                                      token="agent-secret")
    argv = ["--connect", f"127.0.0.1:{src.port}", "--compress", compress, "--fps", "500"]
    try:
        if agent == "jax":
            monkeypatch.setattr(sys, "argv", ["agent", *argv])
            J_agent.main()
        else:
            T_agent.main(argv)
        got = _grab_until(src, _FakeScreen.FRAMES[-1])
        for g in got:
            assert any(np.array_equal(g, f) for f in _FakeScreen.FRAMES)
    finally:
        src.close()


def test_capture_agent_rejects_a_bad_port():
    with pytest.raises(SystemExit, match="HOST"):
        T_agent.main(["--connect", "127.0.0.1:99999", "--source", "synthetic",
                      "--size", "8x8"])


def test_capture_agent_streams_to_a_ring_the_jax_binding_reads(monkeypatch):
    """`capture_agent --ring` (local mode) into the port's ShmFrameRing; the
    JAX package's binding reads the last frame."""
    name = f"/d2s_torch_agent_{os.getpid()}"

    class KeepRing(T_native.ShmFrameRing):
        def close(self):  # the agent's teardown must not unlink before the read
            pass

    monkeypatch.setattr(T_screen, "ScreenSource", _FakeScreen)
    monkeypatch.setattr(T_native, "ShmFrameRing", KeepRing)
    try:
        T_agent.main(["--ring", name, "--fps", "500"])
        reader = J_native.ShmFrameRing(name, create=False)
        try:
            frame, _ = reader.read_latest()
        finally:
            reader.close()
        np.testing.assert_array_equal(frame, _FakeScreen.FRAMES[-1])
    finally:
        with contextlib.suppress(OSError):
            os.unlink(f"/dev/shm{name}")


# ---- the port's copy of tests/test_sources_net.py --------------------------------------


def test_tcp_roundtrip_raw_and_zlib(port_source):
    for compress in ("none", "zlib"):
        src = port_source()
        snd = TcpFrameSender("127.0.0.1", src.port, compress=compress)
        try:
            sent = [_frame(i) for i in range(3)]
            for f in sent:
                snd.send(f)
            delivered = _grab_until(src, sent[-1])
            for g in delivered:
                assert any(np.array_equal(g, f) for f in sent)
            st = src.stats()
            assert st["frames_received"] >= len(delivered)
            assert st["peer"] is not None
        finally:
            snd.close()


def test_tcp_jpeg_roundtrip(port_source):
    pytest.importorskip("cv2")
    src = port_source()
    snd = TcpFrameSender("127.0.0.1", src.port, compress="jpeg", jpeg_quality=95)
    try:
        f = _smooth()
        snd.send(f)
        g = src.grab()
        assert g is not None and g.shape == f.shape
        assert np.abs(g.astype(int) - f.astype(int)).mean() < 8  # lossy: close
    finally:
        snd.close()


def test_tcp_latest_wins_and_drop_stats(port_source):
    src = port_source()
    snd = TcpFrameSender("127.0.0.1", src.port)
    try:
        last = None
        for i in range(20):
            last = _frame(i)
            snd.send(last)
        _wait(lambda: src.stats()["frames_received"] == 20, "20 frames received")
        assert np.array_equal(src.grab(), last)  # the newest frame wins
        st = src.stats()
        assert st["frames_received"] == 20
        assert st["frames_delivered"] == 1
        assert st["frames_dropped"] == 19  # intermediates dropped, not queued
    finally:
        snd.close()


def test_tcp_sender_latest_wins_offer():
    """The agent's depth-1 slot: offers faster than the link replace the
    pending frame (skipped), and the wire never misframes."""
    sink = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sink.bind(("127.0.0.1", 0))
    sink.listen(1)
    accepted = []
    acceptor = threading.Thread(target=lambda: accepted.append(sink.accept()[0]))
    acceptor.start()
    snd = TcpFrameSender("127.0.0.1", sink.getsockname()[1])
    acceptor.join(WAIT_S)
    try:
        accepted[0].setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        snd.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        big = _frame(0, h=256, w=256)  # 256 KB, far beyond the socket buffers
        for _ in range(30):
            snd.offer(big)
        # the first frame blocks the sender in sendall (the peer never
        # reads), so every later offer lands in the slot
        assert snd.skipped > 0
        assert snd.sent + snd.skipped <= 30
    finally:
        for c in accepted:
            c.close()  # the blocked sendall fails, and close() joins the thread
        snd.close()
        sink.close()
    assert not snd._sender_thread.is_alive()


def test_tcp_new_connection_takes_over(port_source):
    src = port_source()
    a = TcpFrameSender("127.0.0.1", src.port)
    b = None
    try:
        a.send(_frame(1))
        assert src.grab() is not None
        b = TcpFrameSender("127.0.0.1", src.port)  # an agent restart
        f2 = _frame(2)
        b.send(f2)
        _grab_until(src, f2)
        _wait(lambda: src.stats()["peer"].endswith(str(b.sock.getsockname()[1])),
              "the takeover")
    finally:
        a.close()
        if b is not None:
            b.close()


def test_tcp_protocol_violation_drops_connection(port_source):
    src = port_source(timeout=0.3)
    raw = socket.create_connection(("127.0.0.1", src.port), timeout=5)
    try:
        raw.sendall(b"GET / HTTP/1.1\r\nHost: d2s\r\n\r\n")  # a handshake's size, not the magic
        assert _closed_by_peer(raw)
        assert src.grab() is None  # nothing ingested
        assert src.stats()["frames_received"] == 0
    finally:
        raw.close()


def test_tcp_grab_timeout_when_agent_gone(port_source):
    src = port_source(timeout=0.3)
    t0 = time.monotonic()
    assert src.grab() is None
    assert time.monotonic() - t0 < WAIT_S  # returned, and did not wait for an agent


def test_tcp_zlib_flag_on_wire(port_source):
    """The zlib flag travels (a silent fallback to raw would triple WAN
    bandwidth)."""
    src = port_source()
    snd = TcpFrameSender("127.0.0.1", src.port, compress="zlib")
    try:
        pkt = snd._pack(np.zeros((16, 16, 4), np.uint8))
        _, _, _, _, flags, plen = T_net._FRAME_HDR.unpack(pkt[:T_net._FRAME_HDR.size])
        assert flags & FLAG_ZLIB
        assert plen < 16 * 16 * 4  # zeros compress
    finally:
        snd.close()


def test_tcp_loopback_end_to_end():
    """Scripted frames → a remote agent (TcpFrameSender over real TCP,
    zlib) → TcpFrameSource → FrameEngine → a collecting sink.  The frames
    are read-only views of the inflated bytes, which the engine's CPU path
    takes without a warning."""
    import warnings

    from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine

    class EchoProgram:
        device = "cpu"

        def __call__(self, frame):
            return frame.clone(), None

    class CollectSink:
        wants_depth = False

        def __init__(self):
            self.frames = []

        def push(self, sbs, depth, stats):
            self.frames.append(np.asarray(sbs))

        def close(self):
            pass

    src = TcpFrameSource(port=0, host="127.0.0.1", timeout=5.0, max_frames=6)
    sink = CollectSink()
    engine = FrameEngine(src, EchoProgram(), sink, target_fps=0.0)
    sent = [_frame(i) for i in range(40)]
    stop = threading.Event()

    def agent():
        snd = TcpFrameSender("127.0.0.1", src.port, compress="zlib")
        try:
            for k, f in enumerate(sent):
                snd.send(f)
                # the next frame once the engine took this one
                _wait(lambda: stop.is_set() or src.stats()["frames_delivered"] > k,
                      "the engine's grab")
                if stop.is_set():
                    break
        finally:
            snd.close()

    t = threading.Thread(target=agent)
    t.start()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stats = engine.run(duration=WAIT_S, max_frames=6)
    stop.set()
    t.join(WAIT_S)
    _close(src)
    assert not t.is_alive()
    assert [str(w.message) for w in caught] == []
    assert 1 <= stats.frames <= 6 and len(sink.frames) >= 1
    for g in sink.frames:  # every output is a sent frame
        assert any(np.array_equal(g, f) for f in sent)
    st = src.stats()
    assert st["frames_delivered"] == 6
    assert st["frames_received"] >= st["frames_delivered"]


def test_tcp_stray_connection_does_not_displace_active_stream(port_source):
    """A port scan or health check (connect, send nothing or garbage) does
    not kill the live capture stream: takeover needs a valid handshake."""
    src = port_source()
    agent = TcpFrameSender("127.0.0.1", src.port)
    try:
        agent.send(_frame(1))
        assert src.grab() is not None
        for garbage in (b"", b"GET / HTTP/1.1\r\nHost: d2s\r\n\r\n"):
            stray = socket.create_connection(("127.0.0.1", src.port), timeout=5)
            if garbage:
                stray.sendall(garbage)
                assert _closed_by_peer(stray)  # refused
            stray.close()
        f2 = _frame(2)
        agent.send(f2)  # the same connection keeps working
        assert np.array_equal(_grab_until(src, f2)[-1], f2)
    finally:
        agent.close()


def test_tcp_decompression_bomb_bounded(port_source):
    """A small zlib payload claiming huge dims is a decode error (bounded
    inflate), and the connection stays usable for valid frames."""
    src = port_source()
    raw = socket.create_connection(("127.0.0.1", src.port), timeout=5)
    try:
        raw.sendall(T_net._HANDSHAKE.pack(T_net.MAGIC, T_net.VERSION, b"\x00" * 16))
        bomb = zlib.compress(b"\x00" * (1 << 20), 9)  # ~1 KiB on the wire
        raw.sendall(T_net._FRAME_HDR.pack(1, 16384, 16384, 4, FLAG_ZLIB, len(bomb)) + bomb)
        _wait(lambda: src.stats()["decode_errors"] == 1, "the decode error")
        assert src.stats()["frames_received"] == 0
        f = _frame(3, h=8, w=8)
        payload = f.tobytes()
        raw.sendall(T_net._FRAME_HDR.pack(2, 8, 8, 4, 0, len(payload)) + payload)
        got = src.grab()
        assert got is not None and np.array_equal(got, f)
    finally:
        raw.close()


def test_tcp_token_gate(port_source):
    src = port_source(timeout=1.0, token="s3cret")
    bad = TcpFrameSender("127.0.0.1", src.port, token="wrong")
    good = None
    try:
        try:
            bad.send(_frame(1))
        except OSError:
            pass  # the server closed on us: acceptable
        good = TcpFrameSender("127.0.0.1", src.port, token="s3cret")
        f = _frame(2)
        good.send(f)
        assert np.array_equal(_grab_until(src, f)[0], f)
        assert src.stats()["frames_received"] == 1
    finally:
        bad.close()
        if good is not None:
            good.close()


def test_tcp_jpeg_bomb_dims_rejected_before_decode():
    cv2 = pytest.importorskip("cv2")
    ok, enc = cv2.imencode(".jpg", np.zeros((64, 64, 3), np.uint8))
    assert ok
    payload = enc.tobytes()
    assert T_net._jpeg_dims(payload) == (64, 64)
    with pytest.raises(ValueError, match="SOF dims"):
        T_net._decode_payload(payload, 1, 1, 3, T_net.FLAG_JPEG)
    assert T_net._decode_payload(payload, 64, 64, 3, T_net.FLAG_JPEG).shape == (64, 64, 3)


def test_received_frames_and_the_cpu_engine():
    """A raw frame is received straight into a writable array; a zlib frame
    is a read-only view of the inflated bytes.  FrameEngine's CPU path
    copies a frame only when it is read-only."""
    f = _frame(7)
    a, b = socket.socketpair()
    try:
        a.sendall(f.tobytes())
        raw = T_net._decode_payload(T_net._read_exact(b, f.nbytes), 32, 24, 4, 0)
        a.close()
        assert T_net._read_exact(b, 1) is None  # the peer closed
    finally:
        a.close()
        b.close()
    assert raw.flags.writeable and np.array_equal(raw, f)
    assert np.require(raw, requirements="CW") is raw  # not copied
    packed = T_net._decode_payload(zlib.compress(f.tobytes()), 32, 24, 4, FLAG_ZLIB)
    assert not packed.flags.writeable
    req = np.require(packed, requirements="CW")
    assert req.flags.writeable and np.array_equal(req, f)
    assert torch.from_numpy(req).shape == (24, 32, 4)
