"""Frozen copy of staticfusion_tpu_torch/solver/segmentation.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Static/dynamic cluster segmentation (port of
staticfusion_tpu/solver/segmentation.py; reference
SegmentationBackground.cpp:53-197).  The K x K normal equations are
assembled directly: connection rows contribute (2*lambda_reg)^2 times the
graph Laplacian, data/prior rows a diagonal."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfbench.reference.sf.config import NUM_CLUSTERS, SFConfig
from sfbench.reference.sf.ops.smallsolve import spd_solve_fast


class SegPrior(NamedTuple):
    b_prior: torch.Tensor     # (K,)
    lambda_t_w: torch.Tensor  # (K,) per-cluster trust


def compute_seg_prior(onehot: torch.Tensor, null: torch.Tensor,
                      ddt: torch.Tensor, config: SFConfig) -> SegPrior:
    """b_prior = mean(1 - kz|ddt|) over non-null pixels per cluster;
    clusters with < 10% valid depth get prior -1 and trust 0.1."""
    kz = config.solver.kz
    oh = onehot[:, :NUM_CLUSTERS]
    nonnull = (~null.reshape(-1)).to(torch.float32)
    contrib = nonnull * (1.0 - kz * torch.abs(ddt.reshape(-1)))
    size = torch.sum(oh, dim=0)
    nn_ = nonnull @ oh
    b_sum = contrib @ oh
    zero = torch.zeros_like(size)
    ratio = torch.where(size > 0, nn_ / torch.clamp(size, min=1.0), zero)
    b_mean = torch.clamp(b_sum / torch.clamp(nn_, min=1.0), -1.0, 2.0)
    starved = (size > 0) & (ratio < 0.1)
    healthy = (size > 0) & (ratio >= 0.1)
    b_prior = torch.where(starved, torch.full_like(size, -1.0),
                          torch.where(healthy, b_mean, zero))
    lambda_t_w = torch.where(starved, torch.full_like(size, 0.1),
                             torch.where(healthy, ratio, zero))
    return SegPrior(b_prior=b_prior, lambda_t_w=lambda_t_w)


def reg_normal_matrix(connectivity: torch.Tensor,
                      lambda_reg: float) -> torch.Tensor:
    """(2 lambda_reg)^2 * Laplacian of the off-diagonal connectivity."""
    w = 2.0 * lambda_reg
    eye = torch.eye(NUM_CLUSTERS, dtype=torch.bool,
                    device=connectivity.device)
    a = (connectivity & ~eye).to(torch.float32)
    return (w * w) * (torch.diag(torch.sum(a, dim=1)) - a)


def solve_segm_iteration(aver_res_label: torch.Tensor,
                         aver_res_overall: torch.Tensor, prior: SegPrior,
                         reg_ata: torch.Tensor, config: SFConfig,
                         kb=None) -> torch.Tensor:
    """One coupled segmentation solve (SegmentationBackground.cpp:133-174),
    clamped to [-1, 2].  `kb` may be a device scalar (1.05 warm-up, 1.5
    steady)."""
    s = config.solver
    if kb is None:
        kb = s.kb
    repr_res = torch.clamp(aver_res_overall, min=0.001)
    mult_res = 1.0 / (s.kc_cauchy * torch.clamp(aver_res_overall, min=1e-20))
    fixed_term = torch.log1p((kb * repr_res * mult_res) ** 2)
    trusted = prior.lambda_t_w > 0.1
    dataterm = fixed_term - torch.log1p((aver_res_label * mult_res) ** 2)
    a_diag = torch.where(trusted, 2.0 * prior.lambda_t_w * s.lambda_prior,
                         2.0 * prior.lambda_t_w)
    b_rhs = torch.where(
        trusted, dataterm + 2.0 * s.lambda_prior * prior.lambda_t_w
        * prior.b_prior, 2.0 * prior.lambda_t_w * prior.b_prior)
    ata = torch.diag(a_diag * a_diag) + reg_ata
    sol = spd_solve_fast(ata, a_diag * b_rhs, ridge=1e-6)
    return torch.clamp(sol, -1.0, 2.0)


def build_segm_image(labels_full: torch.Tensor, b_segm: torch.Tensor,
                     per_cluster_residual: torch.Tensor,
                     config: SFConfig) -> torch.Tensor:
    """Per-pixel static probability (SegmentationBackground.cpp:176-197);
    NaN per-cluster residuals compare false, as in the reference."""
    k = NUM_CLUSTERS
    dev = b_segm.device
    b_ext = torch.cat([torch.clamp(b_segm, 0.0, 1.0),
                       torch.ones(1, dtype=b_segm.dtype, device=dev)])
    lbl = torch.clamp(labels_full, 0, k).long()
    b_img = b_ext[lbl]
    res_ext = torch.cat([per_cluster_residual,
                         torch.full((1,), float("nan"), device=dev)])
    rescue = res_ext[lbl] < config.rescue_residual_threshold
    return torch.where(rescue & (labels_full < k),
                       torch.maximum(b_img, 1.0 - b_img), b_img)
