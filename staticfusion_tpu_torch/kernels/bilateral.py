"""K1 wrappers: the depth preprocessing kernel (csrc/bilateral.cu), which
filters a millimetre depth image and converts the raw and the filtered
image to metres in one launch.

Plain versions: `preprocess_depth_mm_plain` and `bilateral_filter_mm_plain`
(ops/bilateral.py, re-exported here).  `preprocess_depth_cuda` is the
frame's call; `bilateral_filter_mm_cuda` asks the same kernel for the
filtered millimetres alone.  `.launches` on each counts its launches.
"""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.kernels import _build
from staticfusion_tpu_torch.ops.bilateral import (  # noqa: F401
    MIN_DEPTH_MM, bilateral_filter_mm_plain, preprocess_depth_mm_plain)


_OUTPUTS = ("filt_mm", "raw_m", "filt_m")  # sf_preprocess's, in order


def _launch(wrapper, depth_mm: torch.Tensor, max_depth_m: float,
            outputs: tuple) -> dict:
    """One launch that writes the named outputs (of _OUTPUTS), counted on
    `wrapper`; returns them by name."""
    _build.require(depth_mm, "depth_mm", torch.float32)
    if depth_mm.dim() != 2:
        raise ValueError(f"depth_mm: expected 2-D, got {tuple(depth_mm.shape)}")
    lib = _build.load()
    rows, cols = depth_mm.shape
    out = {name: torch.empty_like(depth_mm) for name in outputs}
    wrapper.launches += 1
    _build.check(lib.sf_preprocess(
        depth_mm.data_ptr(),
        *(out[name].data_ptr() if name in out else None for name in _OUTPUTS),
        rows, cols, MIN_DEPTH_MM, float(max_depth_m) * 1000.0,
        _build.stream_ptr(depth_mm)), "sf_preprocess")
    return out


def preprocess_depth_cuda(depth_mm: torch.Tensor, max_depth_m: float):
    """(raw_m, filt_m) of a (rows, cols) float32 mm image, on the CUDA
    tensor's device and current stream; the filtered millimetres are not
    stored."""
    out = _launch(preprocess_depth_cuda, depth_mm, max_depth_m,
                  ("raw_m", "filt_m"))
    return out["raw_m"], out["filt_m"]


def bilateral_filter_mm_cuda(depth_mm: torch.Tensor,
                             max_depth_m: float) -> torch.Tensor:
    """(rows, cols) float32 mm -> filtered mm, on the CUDA tensor's
    device and current stream."""
    return _launch(bilateral_filter_mm_cuda, depth_mm, max_depth_m,
                   ("filt_mm",))["filt_mm"]


preprocess_depth_cuda.launches = 0
bilateral_filter_mm_cuda.launches = 0
