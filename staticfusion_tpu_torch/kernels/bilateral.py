"""K1 wrapper: the CUDA bilateral filter (csrc/bilateral.cu).

Plain version: `bilateral_filter_mm_plain` (ops/bilateral.py, re-exported
here).  `bilateral_filter_mm_cuda.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.kernels import _build
from staticfusion_tpu_torch.ops.bilateral import (  # noqa: F401
    MIN_DEPTH_MM, bilateral_filter_mm_plain)


def bilateral_filter_mm_cuda(depth_mm: torch.Tensor,
                             max_depth_m: float) -> torch.Tensor:
    """(rows, cols) float32 mm -> filtered mm, on the CUDA tensor's
    device and current stream."""
    _build.require(depth_mm, "depth_mm", torch.float32)
    if depth_mm.dim() != 2:
        raise ValueError(f"depth_mm: expected 2-D, got {tuple(depth_mm.shape)}")
    lib = _build.load()
    rows, cols = depth_mm.shape
    out = torch.empty_like(depth_mm)
    bilateral_filter_mm_cuda.launches += 1
    _build.check(lib.sf_bilateral(depth_mm.data_ptr(), out.data_ptr(), rows,
                                  cols, MIN_DEPTH_MM,
                                  float(max_depth_m) * 1000.0,
                                  _build.stream_ptr(depth_mm)),
                 "sf_bilateral")
    return out


bilateral_filter_mm_cuda.launches = 0
