"""Live RGB-D frame stream bridge (port of staticfusion_tpu/io/stream.py:
the same bytes on the wire, the same delivery semantics) — the host-side
replacement for the reference's OpenNI2 capture
(`Utils/RGBD_Camera.{h,cpp}`).

A live camera reaches the host as a byte stream (socket, FIFO, or pipe
from a capture daemon on the sensor machine).  This module defines that
wire format and a `StreamSource` that feeds `apps/run_camera.py` with
live-capture semantics:

* **Wire format** ("SFRD" stream, little-endian):
    stream header:  magic b"SFRD" | u32 version=1 | u32 width | u32 height
    per frame:      magic b"FRME" | f64 timestamp (unix seconds)
                    | H*W*3 bytes rgb (u8, row-major)
                    | H*W*2 bytes depth (u16 millimeters)
  A clean end of stream is EOF at a frame boundary (or b"FEND").
* **Sensor-like preprocessing** (RGBD_Camera.cpp:51,155-167): depth
  beyond `max_distance_m` (reference: 3.0 m) is zeroed; optional
  horizontal mirroring (the reference enables OpenNI mirroring,
  RGBD_Camera.cpp:87-93).
* **Drop-to-latest delivery**: a real camera produces frames at sensor
  rate regardless of the consumer; when the SLAM loop is slower, stale
  frames are DROPPED, not queued (the reference blocks on
  `waitForStreams` and always reads the newest buffer).  A reader thread
  drains the stream continuously and `get()` returns the newest frame,
  counting drops; `latest_only=False` delivers every frame (for
  deterministic replay of recorded streams).
* Per-frame capture->delivery latency is recorded in `latencies`.

Producer side: `write_stream_header` / `write_frame` / `write_stream_end`
emit the same format.  NumPy and the standard library only.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import BinaryIO, Optional, Tuple

import numpy as np

MAGIC_STREAM = b"SFRD"
MAGIC_FRAME = b"FRME"
MAGIC_END = b"FEND"
VERSION = 1

# RGBD_Camera.cpp:51 — the live sensor truncates at 3 m (tighter than the
# dataset pipeline's 4.5 m depth_max; near-range IR stereo gets noisy fast).
CAMERA_MAX_DISTANCE_M = 3.0


def write_stream_header(f: BinaryIO, width: int, height: int):
    f.write(MAGIC_STREAM + struct.pack("<III", VERSION, width, height))


def write_frame(f: BinaryIO, rgb: np.ndarray, depth_mm: np.ndarray,
                timestamp: float):
    """rgb: (H,W,3) u8 or float in [0,1]; depth_mm: (H,W) u16-valued."""
    if rgb.dtype != np.uint8:
        rgb = np.round(np.clip(np.asarray(rgb), 0.0, 1.0)
                       * 255.0).astype(np.uint8)
    depth = np.asarray(depth_mm).astype("<u2")
    f.write(MAGIC_FRAME + struct.pack("<d", timestamp))
    f.write(np.ascontiguousarray(rgb).tobytes())
    f.write(depth.tobytes())


def write_stream_end(f: BinaryIO):
    f.write(MAGIC_END)


class StreamFormatError(ValueError):
    pass


def _read_exact(f: BinaryIO, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            return None if not buf else buf  # EOF (partial = corrupt)
        buf += chunk
    return buf


class StreamReader:
    """Blocking parser of one SFRD stream."""

    def __init__(self, f: BinaryIO):
        self.f = f
        hdr = _read_exact(f, 4 + 12)
        if hdr is None or len(hdr) != 16 or hdr[:4] != MAGIC_STREAM:
            raise StreamFormatError("not an SFRD stream")
        self.version, self.width, self.height = struct.unpack("<III",
                                                              hdr[4:])
        if self.version != VERSION:
            raise StreamFormatError(f"unsupported version {self.version}")

    def next_frame(self) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        """(timestamp, rgb u8 (H,W,3), depth u16 mm (H,W)) or None at end."""
        magic = _read_exact(self.f, 4)
        if magic is None or magic == MAGIC_END:
            return None
        if magic != MAGIC_FRAME:
            raise StreamFormatError(f"bad frame magic {magic!r}")
        h, w = self.height, self.width
        ts = struct.unpack("<d", _read_exact(self.f, 8))[0]
        rgb_b = _read_exact(self.f, h * w * 3)
        dep_b = _read_exact(self.f, h * w * 2)
        if rgb_b is None or dep_b is None or len(dep_b) != h * w * 2:
            raise StreamFormatError("truncated frame payload")
        rgb = np.frombuffer(rgb_b, np.uint8).reshape(h, w, 3)
        depth = np.frombuffer(dep_b, "<u2").reshape(h, w)
        return ts, rgb, depth


def open_stream(spec: str, timeout: float = 30.0) -> BinaryIO:
    """Open a stream by spec:
      tcp://host:port    connect to a capture daemon
      listen://port      accept ONE producer connection
      fifo://path        open a named pipe (blocks for the producer)
      <path>             recorded stream file
    """
    if spec.startswith("tcp://"):
        host, port = spec[6:].rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=timeout)
        s.settimeout(timeout)
        return s.makefile("rb")
    if spec.startswith("listen://"):
        port = int(spec[9:])
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(1)
        srv.settimeout(timeout)
        conn, _ = srv.accept()
        srv.close()
        conn.settimeout(timeout)
        return conn.makefile("rb")
    if spec.startswith("fifo://"):
        return open(spec[7:], "rb")
    return open(spec, "rb")


class StreamSource:
    """`apps.run_camera.FrameSource` over an SFRD byte stream.

    latest_only=True (live semantics): a reader thread drains the stream
    at full rate into a 1-slot buffer; `get()` blocks for the next unseen
    frame and skips anything older, incrementing `dropped`.
    latest_only=False (replay semantics): `get()` parses the next frame
    inline — every frame is delivered, in order, deterministically."""

    def __init__(self, f_or_spec, max_distance_m: float = CAMERA_MAX_DISTANCE_M,
                 mirror: bool = False, latest_only: bool = True):
        f = (open_stream(f_or_spec) if isinstance(f_or_spec, str)
             else f_or_spec)
        self.reader = StreamReader(f)
        self.max_distance_m = max_distance_m
        self.mirror = mirror
        self.latest_only = latest_only
        self.dropped = 0
        self.received = 0
        self.latencies = []          # capture->delivery seconds per get()
        self._buf = deque(maxlen=1)
        self._cv = threading.Condition()
        self._eof = False
        if latest_only:
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    # -- reader thread (live mode) --
    def _drain(self):
        while True:
            try:
                item = self.reader.next_frame()
            except (StreamFormatError, OSError):
                item = None
            with self._cv:
                if item is None:
                    self._eof = True
                else:
                    if self._buf:
                        self.dropped += 1
                    self._buf.append(item)
                    self.received += 1
                self._cv.notify()
                if item is None:
                    return

    def _convert(self, ts, rgb_u8, depth_u16):
        rgb = rgb_u8.astype(np.float32) / 255.0
        depth = depth_u16.astype(np.float32)
        # RGBD_Camera.cpp:155-167: beyond-range samples become 0 (invalid).
        depth = np.where(depth < self.max_distance_m * 1000.0, depth, 0.0)
        if self.mirror:   # RGBD_Camera.cpp:87-93
            rgb = rgb[:, ::-1]
            depth = depth[:, ::-1]
        self.latencies.append(max(0.0, time.time() - ts))
        return np.ascontiguousarray(rgb), np.ascontiguousarray(depth), ts

    def get(self):
        """(rgb float (H,W,3), depth_mm float (H,W), timestamp) or None."""
        if not self.latest_only:
            item = self.reader.next_frame()
            if item is None:
                return None
            self.received += 1
            return self._convert(*item)
        with self._cv:
            while not self._buf and not self._eof:
                self._cv.wait(timeout=0.1)
            if not self._buf:
                return None
            item = self._buf.popleft()
        return self._convert(*item)
