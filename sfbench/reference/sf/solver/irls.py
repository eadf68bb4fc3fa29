"""Frozen copy of staticfusion_tpu_torch/solver/irls.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Joint odometry + segmentation IRLS solver (port of
staticfusion_tpu/solver/irls.py; reference FrontEnd.cpp:513-772).

`solve_irls_xla` is the plain version of the coupled loop (the JAX
package's XLA formulation, same name so the two line up); `solve_irls`
dispatches on the device: the one-launch CUDA kernel (kernels/irls.py,
csrc/irls.cu) for CUDA tensors, the plain loop for CPU tensors.
`solve_irls_filtered`, the solver's call, adds the motion filter: inside
the same launch on the card, `motion_filter` after the plain loop on the
CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sfbench.reference.sf.config import NUM_CLUSTERS, SFConfig
from sfbench.reference.sf.geometry import se3
from sfbench.reference.sf.ops.derivatives import (Derivatives, InterCoords,
                                                    PreWeights)
from sfbench.reference.sf.ops.smallsolve import (spd_inverse_fast,
                                                   spd_solve_fast)
from sfbench.reference.sf.solver.segmentation import (SegPrior,
                                                        solve_segm_iteration)


def cluster_onehot(labels: torch.Tensor) -> torch.Tensor:
    """(N, K+1) float one-hot of the flattened labels (column K = invalid)."""
    flat = torch.clamp(labels.reshape(-1), 0, NUM_CLUSTERS)
    return (flat[:, None] == torch.arange(
        NUM_CLUSTERS + 1, device=labels.device)[None, :]).to(torch.float32)


class JacobianSystem(NamedTuple):
    A_cT: torch.Tensor   # (6, N) photometric rows
    B_c: torch.Tensor    # (N,)
    A_dT: torch.Tensor   # (6, N) geometric rows
    B_d: torch.Tensor    # (N,)
    labels: torch.Tensor  # (N,) labels clipped to [0, K]
    onehot: torch.Tensor  # (N, K+1)
    cluster_counts: torch.Tensor  # (K,)
    valid_count: torch.Tensor     # scalar


class IRLSResult(NamedTuple):
    twist: torch.Tensor     # (6,)
    est_cov: torch.Tensor   # (6, 6)
    b_segm: torch.Tensor    # (K,)
    aver_res: torch.Tensor  # scalar


def build_jacobian(inter: InterCoords, deriv: Derivatives, w: PreWeights,
                   labels: torch.Tensor, onehot: torch.Tensor,
                   config: SFConfig) -> JacobianSystem:
    """Photometric + geometric rows of the range/optical-flow constraint
    (FrontEnd.cpp:537-586), (6, N) each."""
    rows_i, cols_i = inter.depth.shape
    f_inv = float(cols_i) / (2.0 * math.tan(0.5 * config.camera.fovh))
    d = inter.depth
    nz = d != 0.0
    # Double where: 1/d is never evaluated at d == 0 (no inf to mask).
    inv_d = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                        torch.zeros_like(d))
    x, y = inter.xx, inter.yy

    def rows6(du, dv, tw, g):
        dy = du * f_inv * inv_d
        dz = dv * f_inv * inv_d
        a = [tw * (-dy), tw * (-dz),
             tw * (g + dy * x * inv_d + dz * y * inv_d),
             tw * (g * y + dy * inv_d * y * x + dz * (y * y * inv_d + d)),
             tw * (-g * x - dy * (x * x * inv_d + d) - dz * inv_d * y * x),
             tw * (dy * y - dz * x)]
        return torch.stack([r.reshape(-1) for r in a], dim=0)

    twc = w.weights_c * config.solver.k_photometric_res
    twd = w.weights_d
    A_cT = rows6(deriv.dcu, deriv.dcv, twc, 0.0)
    B_c = (twc * (-deriv.dct)).reshape(-1)
    A_dT = rows6(deriv.ddu, deriv.ddv, twd, 1.0)
    B_d = (twd * (-deriv.ddt)).reshape(-1)
    return JacobianSystem(
        A_cT=A_cT, B_c=B_c, A_dT=A_dT, B_d=B_d,
        labels=torch.clamp(labels.reshape(-1), 0, NUM_CLUSTERS).to(
            torch.int32),
        onehot=onehot,
        cluster_counts=torch.sum(onehot[:, :NUM_CLUSTERS], dim=0),
        valid_count=torch.sum(inter.valid.to(torch.float32)))


def initial_aver_res(sys: JacobianSystem):
    """(n2, aver_res0): the normaliser 2*valid and the starting average
    residual of the loop."""
    n2 = torch.clamp(2.0 * sys.valid_count, min=1.0)
    return n2, (torch.sum(torch.abs(sys.B_c))
                + torch.sum(torch.abs(sys.B_d))) / n2


def solve_irls(sys: JacobianSystem, b_segm0: torch.Tensor, prior: SegPrior,
               reg_ata: torch.Tensor, config: SFConfig, kb=None) -> IRLSResult:
    """Device dispatch of the coupled IRLS loop."""
    return solve_irls_xla(sys, b_segm0, prior, reg_ata, config, kb=kb)


def solve_irls_filtered(sys: JacobianSystem, b_segm0: torch.Tensor,
                        prior: SegPrior, reg_ata: torch.Tensor,
                        config: SFConfig, twist_old: torch.Tensor,
                        T_odo: torch.Tensor, level: int, kb=None):
    """(IRLSResult, twist): the coupled IRLS loop, then, when
    `config.solver.use_motion_filter`, the motion filter of its twist at
    `level` against the accumulated `T_odo` (else the twist unfiltered).
    CUDA tensors take one launch of the K3 kernel, which runs the filter
    in its epilogue; CPU tensors the plain loop, then `motion_filter`."""
    acc = se3.se3_log(T_odo) if config.solver.use_motion_filter else None
    result = solve_irls_xla(sys, b_segm0, prior, reg_ata, config, kb=kb)
    if acc is None:
        return result, result.twist
    return result, motion_filter(result.twist, result.est_cov, twist_old,
                                 acc, level, config)


def solve_irls_xla(sys: JacobianSystem, b_segm0: torch.Tensor,
                   prior: SegPrior, reg_ata: torch.Tensor, config: SFConfig,
                   kb=None) -> IRLSResult:
    """The coupled IRLS loop (FrontEnd.cpp:593-689), plain version.  The
    convergence break comes after the iteration's update, so the converged
    iteration's values are kept.  Reads the `done` flag on the host once per
    iteration."""
    s = config.solver
    k = NUM_CLUSTERS
    n2, aver_res = initial_aver_res(sys)
    res_c, res_d = -sys.B_c, -sys.B_d
    b_segm = b_segm0
    one = torch.ones(1, dtype=b_segm0.dtype, device=b_segm0.device)
    prev_sol = torch.zeros(6, dtype=torch.float32, device=b_segm0.device)
    var = prev_sol
    AtA = torch.eye(6, device=b_segm0.device)
    for _ in range(s.max_iter_irls):
        inv_c = 1.0 / (s.kc_cauchy * torch.clamp(aver_res, min=1e-20))
        b_weight = sys.onehot @ torch.clamp(torch.cat([b_segm, one]),
                                            0.0, 1.0)
        wc = b_weight * torch.sqrt(1.0 / (1.0 + (res_c * inv_c) ** 2))
        wd = b_weight * torch.sqrt(1.0 / (1.0 + (res_d * inv_c) ** 2))
        Awc = sys.A_cT * wc[None, :]
        Awd = sys.A_dT * wd[None, :]
        AtA = Awc @ Awc.T + Awd @ Awd.T
        AtB = Awc @ (wc * sys.B_c) + Awd @ (wd * sys.B_d)
        var = spd_solve_fast(AtA, AtB, ridge=1e-12)

        res_c = var @ sys.A_cT - sys.B_c
        res_d = var @ sys.A_dT - sys.B_d
        ress = torch.abs(res_c) + torch.abs(res_d)
        sums = (ress @ sys.onehot)[:k]
        aver_res_label = sums / (2.0 * (sys.cluster_counts + 1.0))
        b_segm = solve_segm_iteration(aver_res_label, aver_res, prior,
                                      reg_ata, config, kb=kb)
        aver_res = torch.sum(sums) / n2
        done = bool(torch.max(torch.abs(prev_sol - var))
                    < s.irls_delta_threshold)
        prev_sol = var
        if done:
            break

    res_sq = torch.sum(res_c * res_c) + torch.sum(res_d * res_d)
    est_cov = spd_inverse_fast(AtA, ridge=1e-12) * res_sq  # FrontEnd.cpp:689
    return IRLSResult(twist=var, est_cov=est_cov, b_segm=b_segm,
                      aver_res=aver_res)


def motion_filter_weights(level: int, config: SFConfig) -> tuple:
    """(cf, df): the motion filter's covariance and constant weights at
    solver level `level` (FrontEnd.cpp:713-756)."""
    s = config.solver
    return (s.previous_speed_eig_weight * math.exp(-level),
            s.previous_speed_const_weight * math.exp(-level))


def motion_filter(twist: torch.Tensor, est_cov: torch.Tensor,
                  twist_old: torch.Tensor, accumulated_twist: torch.Tensor,
                  level: int, config: SFConfig) -> torch.Tensor:
    """Low-pass the level twist in the covariance eigenbasis
    (FrontEnd.cpp:713-756) as one 6x6 SPD solve:
    M = (1+df) I + cf C;  kai_fil = M^-1 (kai + (cf C + df I) kai_old)."""
    kai_loc_sub = twist_old - accumulated_twist
    cf, df = motion_filter_weights(level, config)
    eye = torch.eye(6, dtype=est_cov.dtype, device=est_cov.device)
    M = (1.0 + df) * eye + cf * est_cov
    rhs = twist + cf * (est_cov @ kai_loc_sub) + df * kai_loc_sub
    return spd_solve_fast(M, rhs)
