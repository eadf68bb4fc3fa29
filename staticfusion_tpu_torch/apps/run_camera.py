"""Live-camera entry point (the reference's StaticFusion-camera.cpp); the
port's copy of apps/run_camera.py, with `--device` (the card by default;
`--device cpu` runs the plain versions).

The live path consumes an RGB-D byte stream (socket / FIFO / recorded file;
io/stream.py defines the wire format) with the reference sensor's
semantics: 3 m depth truncation, drop-to-latest delivery, and per-frame
capture->pose latency accounting.  `--source synthetic` runs the built-in
analytic world instead; any object with the `FrameSource` contract
(get() -> (rgb, depth_mm[, timestamp]) or None) also plugs in.

  python -m staticfusion_tpu_torch.apps.run_camera --source synthetic --frames 60
  python -m staticfusion_tpu_torch.apps.run_camera --source listen://7070
  python -m staticfusion_tpu_torch.apps.run_camera --source tcp://cam-host:7070
  python -m staticfusion_tpu_torch.apps.run_camera --source fifo:///tmp/rgbd.fifo
  python -m staticfusion_tpu_torch.apps.run_camera --source recorded.sfrd --replay
"""

import argparse
import time

import numpy as np

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.io import synthetic
from staticfusion_tpu_torch.io.stream import StreamSource
from staticfusion_tpu_torch.pipeline.system import SlamSystem

# The synthetic source's camera motion per frame (se3 twist), as the JAX
# app's.
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)


class FrameSource:
    """Override get() to supply frames; return None to stop."""

    def get(self):
        raise NotImplementedError


class SyntheticSource(FrameSource):
    """Built-in demo source: the analytic test world with a moving camera.
    `gt` holds the sequence's camera-to-world poses."""

    def __init__(self, config, n_frames=100):
        self.frames, self.gt = synthetic.make_sequence(config, n_frames,
                                                       TWIST)
        self.i = 0

    def get(self):
        if self.i >= len(self.frames):
            return None
        rgb, depth_mm, _ = self.frames[self.i]
        self.i += 1
        return rgb, depth_mm


def run_loop(slam, source, max_frames=None, log_every=10):
    """The steady-state capture loop (StaticFusion-camera.cpp:118-150).
    Returns per-frame latencies in seconds (capture->pose, when the source
    timestamps its frames): each is taken once the frame's step has
    finished on the device."""
    i = 0
    latencies = []
    while max_frames is None or i < max_frames:
        frame = source.get()
        if frame is None:
            break
        rgb, depth_mm = frame[0], frame[1]
        ts = frame[2] if len(frame) > 2 else i / 30.0
        out = slam.process(rgb, depth_mm, timestamp=ts)
        if len(frame) > 2:
            slam.block()
            latencies.append(time.time() - ts)
        if out is not None and i % log_every == 0:
            lat = f" latency={latencies[-1]*1e3:.0f}ms" if latencies else ""
            drop = (f" dropped={source.dropped}"
                    if hasattr(source, "dropped") else "")
            print(f"frame {i}: surfels={int(out.surfel_count)} "
                  f"fps={1.0 / max(slam.frame_seconds[-1], 1e-9):.1f}"
                  f"{lat}{drop}", flush=True)
        i += 1
    return latencies


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", default="synthetic",
                    help="synthetic | tcp://h:p | listen://p | fifo://path "
                         "| recorded stream file")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--replay", action="store_true",
                    help="deliver every stream frame (deterministic replay) "
                         "instead of drop-to-latest live semantics")
    ap.add_argument("--mirror", action="store_true",
                    help="horizontal mirror (the reference's OpenNI "
                         "mirroring, RGBD_Camera.cpp:87-93)")
    ap.add_argument("--out", default="live_trajectory.txt")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    config = SFConfig()
    slam = SlamSystem(config, device=args.device)
    if args.source == "synthetic":
        source = SyntheticSource(config, args.frames)
        max_frames = None
    else:
        source = StreamSource(args.source, mirror=args.mirror,
                              latest_only=not args.replay)
        max_frames = args.frames if args.frames > 0 else None

    latencies = run_loop(slam, source, max_frames)
    slam.write_trajectory(args.out)
    print(f"wrote {len(slam.poses)} poses to {args.out}")
    if latencies:
        print(f"capture->pose latency: median "
              f"{np.median(latencies)*1e3:.0f} ms, p90 "
              f"{np.quantile(latencies, 0.9)*1e3:.0f} ms")
    if hasattr(source, "dropped"):
        print(f"stream: {source.received} received, "
              f"{source.dropped} dropped (drop-to-latest)")


if __name__ == "__main__":
    main()
