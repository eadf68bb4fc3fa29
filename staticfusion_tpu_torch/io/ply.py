"""Binary PLY export of the surfel map (port of staticfusion_tpu/io/ply.py).

Reference: `Reconstruction::savePly` (Reconstruction.cpp:358-485): the
vertices above the confidence threshold with color, flipped normal and
radius, binary little-endian.  The native writer (csrc/io/ply_write.cpp)
does the filtering and packing.
"""

from __future__ import annotations

from staticfusion_tpu_torch.io.native import write_ply_native


def save_ply(path: str, smap, confidence_threshold: float) -> int:
    """Write `smap` (the port's SurfelMap, on any device); returns the
    vertex count."""
    return write_ply_native(path, smap, confidence_threshold)


def load_ply_count(path: str) -> int:
    """Parse just the vertex count."""
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("ascii", errors="ignore").strip()
            if line.startswith("element vertex"):
                return int(line.split()[-1])
            if line == "end_header":
                break
    return 0
