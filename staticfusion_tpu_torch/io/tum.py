"""TUM RGB-D dataset loading: association files, ground truth, PNG frames
(port of staticfusion_tpu/io/tum.py).

Reference: `StaticFusion::loadAssoc` / `loadImageFromSequenceAssoc`
(FrontEnd.cpp:183-254) and `Utils/Datasets.{h,cpp}` (groundtruth.txt and
the nearest-timestamp GT association).

Differences from the reference, on purpose (as in the JAX package):
* no vertical flip and no BGR-as-RGB channel swap (FrontEnd.cpp:231-236):
  those are GL-upload artifacts, so the pi-about-Z ground-truth fix-up
  (Datasets.cpp:58-60) is not needed either;
* `depth_scale` is explicit: TUM PNGs store depth*5000 per meter; the
  reference's assoc loader divides by 1000 (FrontEnd.cpp:243), correct only
  for its own recorded sequences.

PNGs are decoded by the native zlib decoder (io/native.py).  Only a file
that decoder rejects goes to Pillow, imported then; without Pillow that
file raises, named.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from staticfusion_tpu_torch.io import native
from staticfusion_tpu_torch.io.trajectory import read_tum_trajectory


@dataclasses.dataclass
class AssocEntry:
    timestamp: float
    rgb_path: str
    depth_path: str


def load_assoc(dataset_dir: str,
               assoc_file: str = "rgbd_assoc.txt") -> List[AssocEntry]:
    """Parse 'ts_color color_file ts_depth depth_file' lines
    (FrontEnd.cpp:196-210; the depth timestamp is the canonical one)."""
    path = os.path.join(dataset_dir, assoc_file)
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            _, color_file, ts_depth, depth_file = parts[:4]
            entries.append(AssocEntry(
                timestamp=float(ts_depth),
                rgb_path=os.path.join(dataset_dir, color_file),
                depth_path=os.path.join(dataset_dir, depth_file)))
    return entries


def load_groundtruth(dataset_dir: str, gt_file: str = "groundtruth.txt"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (times, poses (N,4,4)) from the TUM groundtruth file."""
    return read_tum_trajectory(os.path.join(dataset_dir, gt_file))


def _decode_png(path: str) -> np.ndarray:
    arr = native.decode_png(path)
    if arr is not None:
        return arr
    try:
        from PIL import Image
    except ImportError:
        raise IOError(f"{path}: the native PNG decoder rejects this file and "
                      "Pillow, the fallback, is not installed") from None
    return np.asarray(Image.open(path))


def load_frame(entry: AssocEntry, res_factor: int = 2,
               depth_scale: float = 5000.0) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rgb (H,W,3) float[0,1], depth_mm (H,W) float).

    res_factor subsamples 640x480 -> e.g. 320x240 by point sampling, the
    reference's policy (FrontEnd.cpp:228-251)."""
    rgb = _decode_png(entry.rgb_path)
    depth = _decode_png(entry.depth_path)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    rgb = rgb[..., :3]
    if res_factor > 1:
        rgb = rgb[::res_factor, ::res_factor]
        depth = depth[::res_factor, ::res_factor]
    depth_mm = depth.astype(np.float32) * (1000.0 / depth_scale)
    return rgb.astype(np.float32) / 255.0, depth_mm


class TumSequence:
    """Iterable dataset: yields (rgb, depth_mm, timestamp)."""

    def __init__(self, dataset_dir: str, assoc_file: str = "rgbd_assoc.txt",
                 res_factor: int = 2, depth_scale: float = 5000.0,
                 gt_file: Optional[str] = "groundtruth.txt"):
        self.entries = load_assoc(dataset_dir, assoc_file)
        self.res_factor = res_factor
        self.depth_scale = depth_scale
        self.gt_times = None
        self.gt_poses = None
        if gt_file is not None:
            gt_path = os.path.join(dataset_dir, gt_file)
            if os.path.exists(gt_path):
                self.gt_times, self.gt_poses = load_groundtruth(
                    dataset_dir, gt_file)

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        for e in self.entries:
            rgb, depth_mm = load_frame(e, self.res_factor, self.depth_scale)
            yield rgb, depth_mm, e.timestamp

    def initial_gt_pose(self) -> np.ndarray:
        """GT pose nearest the first frame (the datasets main anchors the map
        there; StaticFusion-datasets.cpp:112,134)."""
        if self.gt_times is None or len(self.entries) == 0:
            return np.eye(4, dtype=np.float32)
        t0 = self.entries[0].timestamp
        j = int(np.argmin(np.abs(self.gt_times - t0)))
        return self.gt_poses[j].astype(np.float32)
