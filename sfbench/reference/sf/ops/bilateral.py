"""Frozen copy of staticfusion_tpu_torch/ops/bilateral.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Depth preprocessing: bilateral filter and metric conversion (port of
staticfusion_tpu/ops/bilateral.py).

Reference: `depth_bilateral.frag` (13x13 window, R=6) and
`depth_metric.frag` (mm -> m with the [300 mm, maxD] gates).
`preprocess_depth_mm` (the frame's call: the raw and the filtered image in
metres) and `bilateral_filter_mm` dispatch on the tensor's device: the
CUDA kernel (kernels/bilateral.py, csrc/bilateral.cu) for CUDA tensors,
the plain versions below for CPU tensors.
"""

from __future__ import annotations

import torch


SIGMA_SPACE2_INV_HALF = 0.024691358
SIGMA_COLOR2_INV_HALF = 0.000555556
RADIUS = 6
MIN_DEPTH_MM = 300.0


def _in_range(d: torch.Tensor, max_depth_m: float) -> torch.Tensor:
    return (d >= MIN_DEPTH_MM) & (d <= max_depth_m * 1000.0)


def bilateral_filter_mm_plain(depth_mm: torch.Tensor,
                              max_depth_m: float) -> torch.Tensor:
    """169 shifted multiply-adds, taps in (dy outer, dx inner) order.
    Out-of-image taps are excluded; in-image zero taps take part;
    out-of-range centres output 0."""
    rows, cols = depth_mm.shape
    d = depth_mm.to(torch.float32)
    r = RADIUS
    padded = torch.nn.functional.pad(d, (r, r, r, r))
    pad_mask = torch.nn.functional.pad(torch.ones_like(d), (r, r, r, r))
    sum1 = torch.zeros_like(d)
    sum2 = torch.zeros_like(d)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = padded[r + dy:r + dy + rows, r + dx:r + dx + cols]
            inb = pad_mask[r + dy:r + dy + rows, r + dx:r + dx + cols]
            space2 = float(dx * dx + dy * dy)
            color2 = (d - nb) ** 2
            w = inb * torch.exp(-(space2 * SIGMA_SPACE2_INV_HALF
                                  + color2 * SIGMA_COLOR2_INV_HALF))
            sum1 = sum1 + nb * w
            sum2 = sum2 + w
    out = torch.round(sum1 / torch.clamp(sum2, min=1e-20))
    return torch.where(_in_range(d, max_depth_m), out, torch.zeros_like(out))


def bilateral_filter_mm(depth_mm: torch.Tensor,
                        max_depth_m: float) -> torch.Tensor:
    """Bilateral-filter a depth image in millimetres (float32 carrying u16
    values).  CUDA tensors run the CUDA kernel, CPU tensors the plain
    version."""
    return bilateral_filter_mm_plain(depth_mm, max_depth_m)


def preprocess_depth_mm_plain(depth_mm: torch.Tensor, max_depth_m: float):
    """(raw_m, filt_m): metricise_depth_mm of the image and of its
    bilateral filter (Reconstruction.cpp:327-346)."""
    filtered_mm = bilateral_filter_mm_plain(depth_mm, max_depth_m)
    return (metricise_depth_mm(depth_mm, max_depth_m),
            metricise_depth_mm(filtered_mm, max_depth_m))


def preprocess_depth_mm(depth_mm: torch.Tensor, max_depth_m: float):
    """(raw_m, filt_m) of a depth image in millimetres: one launch of the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    return preprocess_depth_mm_plain(depth_mm, max_depth_m)


def metricise_depth_mm(depth_mm: torch.Tensor,
                       max_depth_m: float) -> torch.Tensor:
    """mm -> metres with the [0.3, maxD] gate (depth_metric.frag:26-40)."""
    d = depth_mm.to(torch.float32)
    return torch.where(_in_range(d, max_depth_m), d / 1000.0,
                       torch.zeros_like(d))
