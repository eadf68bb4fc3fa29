"""ATE evaluator (the part of staticfusion_tpu/io/trajectory.py that
SlamSystem.ate needs).

The reference delegates ATE to the TUM online service (README.md:65); this
evaluates locally with Horn/Umeyama alignment so the accuracy check runs
offline.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def associate_by_time(t_a: np.ndarray, t_b: np.ndarray,
                      max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Nearest-timestamp association (the TUM tool's default policy)."""
    pairs = []
    j = 0
    for i, ta in enumerate(t_a):
        j = int(np.searchsorted(t_b, ta))
        cands = [c for c in (j - 1, j) if 0 <= c < len(t_b)]
        if not cands:
            continue
        jbest = min(cands, key=lambda c: abs(t_b[c] - ta))
        if abs(t_b[jbest] - ta) <= max_dt:
            pairs.append((i, jbest))
    return pairs


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid (no-scale) alignment src->dst, (N,3) each -> (4,4)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def ate_rmse(est_times: np.ndarray, est_poses: np.ndarray,
             gt_times: np.ndarray, gt_poses: np.ndarray,
             max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE after rigid alignment (meters)."""
    pairs = associate_by_time(est_times, gt_times, max_dt)
    if len(pairs) < 3:
        return float("nan")
    p_est = np.stack([est_poses[i][:3, 3] for i, _ in pairs])
    p_gt = np.stack([gt_poses[j][:3, 3] for _, j in pairs])
    T = umeyama_alignment(p_est, p_gt)
    aligned = p_est @ T[:3, :3].T + T[:3, 3]
    err = aligned - p_gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
