"""Capture agent: a desktop's frames into the pipeline, locally or across
the network.

Port of `desktop2stereo_tpu/tools/capture_agent.py`, on the port's native
runtime, so a desktop without JAX feeds the port's pipeline (and, the wire
being the same, the JAX package's).

Local (shared-memory ring, both processes on one host):

    python -m desktop2stereo_tpu_torch.tools.capture_agent --ring /d2s_frames --fps 60
    python -m desktop2stereo_tpu_torch.cli --source shm --input /d2s_frames --sink mjpeg

Remote (the desktop being converted is another machine than the card's
host; the reference colocates capture with the GPU, reference
capture.py:39-247):

    # on the desktop:
    python -m desktop2stereo_tpu_torch.tools.capture_agent \
        --connect gpu-host:7800 --fps 60 --compress zlib
    # on the card's host:
    python -m desktop2stereo_tpu_torch.cli --source tcp:7800 --sink mjpeg

Delivery is latest-wins at both ends (`sources/net.py`): the agent's sender
thread replaces stale frames when the link is slower than capture, and the
pipeline's ingest slot replaces stale frames when compute is slower than
the link (the reference's depth-1 raw_q, main.py:66-68, across a network
hop).  Set the same `D2S_INGEST_TOKEN` (or `--token`) on both ends, or
neither: a one-sided token is refused.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="d2s-capture-agent")
    p.add_argument("--ring", default="/d2s_frames",
                   help="POSIX shm ring name (local mode)")
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="remote mode: stream frames to a pipeline running "
                        "--source tcp:PORT on HOST instead of local shm")
    p.add_argument("--compress", default="none",
                   choices=["none", "zlib", "jpeg"],
                   help="remote mode payload encoding (zlib is lossless "
                        "stdlib; jpeg needs cv2 and trades quality for "
                        "~10-20x less bandwidth)")
    p.add_argument("--jpeg-quality", type=int, default=85)
    p.add_argument("--token", default=os.environ.get("D2S_INGEST_TOKEN"),
                   help="shared secret for --connect; must match the "
                        "pipeline's D2S_INGEST_TOKEN (unset = open mode)")
    p.add_argument("--retry", type=float, default=60.0,
                   help="remote mode: keep retrying the connect this many "
                        "seconds (the pipeline may still be starting)")
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument("--monitor", type=int, default=0)
    p.add_argument("--display", default="")
    p.add_argument("--slots", type=int, default=3)
    p.add_argument("--duration", type=float)
    p.add_argument("--source", default="screen",
                   choices=["screen", "synthetic"],
                   help="synthetic: a test-pattern feed (loopback tests / "
                        "no-display hosts)")
    p.add_argument("--size", default="1080x1920",
                   help="synthetic source HxW")
    args = p.parse_args(argv)

    from desktop2stereo_tpu_torch.native import FramePacer

    if args.source == "synthetic":
        from desktop2stereo_tpu_torch.sources.synthetic import SyntheticSource

        h, w = (int(v) for v in args.size.split("x"))
        source = SyntheticSource(size=(h, w))
    else:
        from desktop2stereo_tpu_torch.sources.screen import ScreenSource

        source = ScreenSource(monitor_index=args.monitor,
                              display=args.display)
    probe = source.grab()
    if probe is None:
        raise SystemExit("capture failed")

    if args.connect:
        from desktop2stereo_tpu_torch.sources.net import TcpFrameSender

        host, sep, port_s = args.connect.rpartition(":")
        if not sep:                      # `--connect gpu-host` → default port
            host, port_s = args.connect, "7800"
        try:
            port = int(port_s)
            if not 0 <= port <= 65535:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"--connect {args.connect!r}: expected HOST[:PORT 0-65535]")
        # the pipeline may still be building its model when the agent
        # starts: retry the connect for up to retry_s (the reference's
        # capture fallback chains retry the same way, capture.py:457-470)
        retry_s, t0, sender = args.retry, time.time(), None
        while True:
            try:
                sender = TcpFrameSender(host or "127.0.0.1", port,
                                        compress=args.compress,
                                        jpeg_quality=args.jpeg_quality,
                                        token=args.token)
                break
            except OSError as e:
                if time.time() - t0 > retry_s:
                    raise SystemExit(
                        f"could not reach {args.connect} in {retry_s:.0f}s: {e}")
                time.sleep(1.0)
        push, teardown = sender.offer, sender.close
        where = f"tcp://{args.connect} ({args.compress})"
    else:
        from desktop2stereo_tpu_torch.native import ShmFrameRing

        ring = ShmFrameRing(args.ring, max_bytes=probe.nbytes,
                            slots=args.slots)
        push, teardown = ring.write, ring.close
        where = args.ring
        sender = None

    pacer = FramePacer(args.fps)
    print(f"[agent] {probe.shape} @ {args.fps} fps -> {where}")

    n, t0 = 0, time.time()
    t_end = None if args.duration is None else t0 + args.duration
    try:
        push(probe)
        n += 1
        while t_end is None or time.time() < t_end:
            frame = source.grab()
            if frame is None:
                break
            push(frame)
            n += 1
            pacer.wait()
            if n % 300 == 0:
                line = f"[agent] {n} frames, {n / (time.time() - t0):.1f} fps"
                if sender is not None:
                    line += (f", sent {sender.sent}, "
                             f"link-skipped {sender.skipped}")
                print(line)
    except KeyboardInterrupt:
        pass
    except ConnectionError as e:
        print(f"[agent] pipeline connection lost: {e}")
    finally:
        source.close()
        if sender is not None:
            sender.flush(timeout=2.0)
        teardown()
        print(f"[agent] done: {n} frames"
              + (f" (sent {sender.sent}, link-skipped {sender.skipped})"
                 if sender is not None else ""))


if __name__ == "__main__":
    main()
