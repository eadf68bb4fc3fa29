"""RGB-D stream producer: feeds run_camera over the SFRD wire format
(io/stream.py) at a paced sensor rate; the port's copy of
scripts/stream_feed.py.  Host only: it renders the built-in synthetic
world (run_camera's motion) and writes bytes.

This is the capture-daemon template: on a sensor machine, replace the
synthetic frames with the real camera read loop and point it at the SLAM
host.

  python -m staticfusion_tpu_torch.apps.stream_feed --to tcp://slam-host:7070 --fps 30
  python -m staticfusion_tpu_torch.apps.stream_feed --to listen://7070 --frames 120
  python -m staticfusion_tpu_torch.apps.stream_feed --to fifo:///tmp/rgbd.fifo
  python -m staticfusion_tpu_torch.apps.stream_feed --to /tmp/seq.sfrd   # record a file
"""

import argparse
import socket
import time

from staticfusion_tpu_torch.apps.run_camera import TWIST
from staticfusion_tpu_torch.config import CameraConfig, SFConfig
from staticfusion_tpu_torch.io import stream, synthetic


def open_sink(spec: str, retry_s: float = 30.0):
    """A binary file to write the stream to:
      tcp://host:port    connect to a listening SLAM host (retried for
                         `retry_s` while it starts up)
      listen://port      accept ONE consumer connection
      fifo://path        open a named pipe (blocks for the reader)
      <path>             a recorded stream file
    """
    if spec.startswith("tcp://"):
        host, port = spec[6:].rsplit(":", 1)
        deadline = time.time() + retry_s
        while True:
            try:
                s = socket.create_connection((host, int(port)), timeout=5.0)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.5)   # the SLAM host may still be starting up
        return s.makefile("wb")
    if spec.startswith("listen://"):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", int(spec[9:])))
        srv.listen(1)
        conn, _ = srv.accept()
        srv.close()
        return conn.makefile("wb")
    if spec.startswith("fifo://"):
        return open(spec[7:], "wb")
    return open(spec, "wb")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--to", required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--fps", type=float, default=30.0,
                    help="0 = unpaced (as fast as the sink accepts)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    args = ap.parse_args(argv)

    config = SFConfig(camera=CameraConfig(width=args.width,
                                          height=args.height))
    frames, _ = synthetic.make_sequence(config, args.frames, TWIST)

    with open_sink(args.to) as f:
        stream.write_stream_header(f, args.width, args.height)
        t0 = time.time()
        for i, (rgb, depth_mm, _) in enumerate(frames):
            if args.fps > 0:
                dt = t0 + i / args.fps - time.time()
                if dt > 0:
                    time.sleep(dt)
            stream.write_frame(f, rgb, depth_mm, time.time())
            f.flush()
        stream.write_stream_end(f)
    print(f"streamed {len(frames)} frames to {args.to}")
    return len(frames)


if __name__ == "__main__":
    main()
