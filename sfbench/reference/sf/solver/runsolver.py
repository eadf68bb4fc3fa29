"""Frozen copy of staticfusion_tpu_torch/solver/runsolver.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Coarse-to-fine driver of the joint solver (port of
staticfusion_tpu/solver/runsolver.py; reference runSolver,
FrontEnd.cpp:1071-1146).

The per-level early exit (||xi_level|| < 0.04, FrontEnd.cpp:1130) is a
real loop break here, so it reads one flag on the host per level
iteration (at most `max_iter_per_level` x levels = 15 reads a frame at
QVGA).  The break comes after the iteration's update is committed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.geometry import se3
from sfbench.reference.sf.ops.derivatives import (calculate_coords,
                                                    calculate_derivatives,
                                                    compute_weights)
from sfbench.reference.sf.ops.pyramid import Pyramid, PyramidLevel
from sfbench.reference.sf.ops.warp import WarpedImages, warp_images_gather
from sfbench.reference.sf.solver.clustering import (Clustering,
                                                      cluster_frame)
from sfbench.reference.sf.solver.irls import (build_jacobian,
                                                cluster_onehot,
                                                solve_irls_filtered)
from sfbench.reference.sf.solver.segmentation import (compute_seg_prior,
                                                        reg_normal_matrix)


class SolverResult(NamedTuple):
    T_odometry: torch.Tensor      # (4,4) frame-to-frame transform
    twist_odometry: torch.Tensor  # (6,) log of T_odometry
    twist_old_next: torch.Tensor  # (6,) velocity rotated into the new frame
    b_segm: torch.Tensor          # (K,)
    clustering: Clustering
    ddt_full: torch.Tensor        # (rows, cols) final-level depth residual


def _solve_at_level(cur: PyramidLevel, warped: WarpedImages, labels,
                    onehot, b_segm, reg_ata, level_idx: int, T_odo,
                    twist_old, config: SFConfig, kb=None):
    """One warp-free solver iteration at a level."""
    inter = calculate_coords(cur, warped)
    deriv = calculate_derivatives(inter, cur, warped)
    w = compute_weights(deriv, inter.valid)
    prior = compute_seg_prior(onehot, inter.null, deriv.ddt, config)
    sys = build_jacobian(inter, deriv, w, labels, onehot, config)
    # The coarsest level restarts the segmentation from the prior
    # (FrontEnd.cpp:604); later levels refine the carried solution.
    b_init = prior.b_prior if level_idx == 0 else b_segm
    result, twist = solve_irls_filtered(sys, b_init, prior, reg_ata, config,
                                        twist_old, T_odo, level_idx, kb=kb)
    T_new = se3.se3_exp(twist) @ T_odo
    converged = torch.linalg.vector_norm(twist) < \
        config.solver.level_twist_convergence
    return T_new, result.b_segm, converged, deriv.ddt


def run_solver(cur_pyr: Pyramid, pred_pyr: Pyramid, twist_old: torch.Tensor,
               config: SFConfig, kb=None,
               T_init: torch.Tensor | None = None) -> SolverResult:
    """Clustering + coarse-to-fine joint IRLS.  The iteration starts at
    `T_init`, by default identity (the tracking case); wide-baseline
    keyframe verification (pipeline/keyframes.py) passes the
    chain-predicted relative pose, since a baseline of metres is far
    outside the solver's basin from identity."""
    dev = cur_pyr[0].depth.device
    clustering = cluster_frame(cur_pyr, config)
    reg_ata = reg_normal_matrix(clustering.connectivity,
                                config.solver.lambda_reg)
    fovh = config.camera.fovh
    n_levels = config.ctf_levels

    T_odo = torch.eye(4, device=dev) if T_init is None else T_init
    b_segm = torch.full((config.num_clusters,), 0.5, device=dev)
    ddt_full = torch.zeros(cur_pyr[0].depth.shape, device=dev)

    for level_idx in range(n_levels):
        image_level = n_levels - 1 - level_idx
        cur = cur_pyr[image_level]
        pred = pred_pyr[image_level]
        labels = clustering.labels[image_level]
        onehot = cluster_onehot(labels)
        ddt_lvl = torch.zeros(cur.depth.shape, device=dev)
        for k in range(config.solver.max_iter_per_level):
            if level_idx == 0 and k == 0 and T_init is None:
                # The first coarse iteration reuses the prediction as the
                # "warped" view (FrontEnd.cpp:1103-1110), which holds only
                # when the iteration starts at identity.
                warped = WarpedImages(pred.depth, pred.intensity, pred.xx,
                                      pred.yy)
            else:
                warped = warp_images_gather(pred, cur.depth, T_odo, fovh)
            T_odo, b_segm, converged, ddt_lvl = _solve_at_level(
                cur, warped, labels, onehot, b_segm, reg_ata, level_idx,
                T_odo, twist_old, config, kb=kb)
            if bool(converged):
                break
        if image_level == 0:
            ddt_full = ddt_lvl

    twist_odo = se3.se3_log(T_odo)
    Rinv = T_odo[:3, :3].T
    twist_old_next = torch.cat([Rinv @ twist_odo[:3], Rinv @ twist_odo[3:]])
    return SolverResult(T_odometry=T_odo, twist_odometry=twist_odo,
                        twist_old_next=twist_old_next, b_segm=b_segm,
                        clustering=clustering, ddt_full=ddt_full)
