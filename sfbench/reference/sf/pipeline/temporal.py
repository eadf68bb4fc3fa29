"""Frozen copy of staticfusion_tpu_torch/pipeline/temporal.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Temporal residual check against the frame `buffer_length` steps back
(port of staticfusion_tpu/pipeline/temporal.py; reference
computeResidualsAgainstPreviousImage, FrontEnd.cpp:896-1069)."""

from __future__ import annotations

import torch

from sfbench.reference.sf.config import NUM_CLUSTERS, SFConfig
from sfbench.reference.sf.ops.pyramid import PyramidLevel, coords_for_level
from sfbench.reference.sf.ops.segments import bincount_matmul
from sfbench.reference.sf.ops.warp import warp_images_gather


def compute_temporal_residuals(rings, T_odometry: torch.Tensor,
                               im_count: torch.Tensor,
                               depth_current: torch.Tensor,
                               intensity_current: torch.Tensor,
                               labels_full: torch.Tensor,
                               config: SFConfig) -> torch.Tensor:
    """(K,) per-cluster average residuals against the oldest ring frame;
    NaN for empty clusters.  T = prod_{i} odom[(im_count-L+1+i) % L] @
    T_odometry (FrontEnd.cpp:898-909); `im_count` stays on the device."""
    L = config.buffer_length
    k = NUM_CLUSTERS
    T_fwd = torch.eye(4, device=T_odometry.device)
    for i in range(L - 1):
        T_fwd = T_fwd @ rings.odom[torch.remainder(im_count - (L - 1) + i, L)]
    T_fwd = T_fwd @ T_odometry

    idx = torch.remainder(im_count, L)
    depth_old = rings.depth[idx]
    xx, yy = coords_for_level(depth_old, config.camera.fovh)
    warped = warp_images_gather(
        PyramidLevel(depth_old, rings.intensity[idx], xx, yy),
        depth_current, T_fwd, config.camera.fovh)

    hit = warped.depth != 0.0
    zero = torch.zeros_like(depth_current)
    depth_res = torch.where(hit, depth_current - warped.depth, zero)
    intensity_res = torch.where(hit, intensity_current - warped.intensity,
                                zero)
    cumulative = (torch.abs(depth_res)
                  + config.solver.k_photometric_res * torch.abs(intensity_res))
    counted = hit & (depth_current != 0.0)
    sums, cnts = bincount_matmul(labels_full.reshape(-1),
                                 cumulative.reshape(-1),
                                 (counted & (labels_full < k)).reshape(-1), k)
    avg = sums / (2.0 * (cnts + 1.0))  # the reference's +1/x2 accounting
    return torch.where(cnts > 0, avg, torch.full_like(avg, float("nan")))
