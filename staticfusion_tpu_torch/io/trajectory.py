"""TUM-format trajectory export and import, and the ATE and RPE
evaluators (port of staticfusion_tpu/io/trajectory.py).

The reference writes TUM-format trajectories (Utils/Datasets.cpp:252-266)
and delegates ATE to the TUM online service (README.md:65); this evaluates
locally with Horn/Umeyama alignment so the accuracy check runs offline.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pose_to_tum_line(timestamp: float, pose: np.ndarray) -> str:
    """TUM line: t tx ty tz qx qy qz qw (Datasets.cpp:252-266)."""
    from scipy.spatial.transform import Rotation

    t = pose[:3, 3]
    q = Rotation.from_matrix(pose[:3, :3].astype(np.float64)).as_quat()
    return (f"{timestamp:.4f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")


def write_tum_trajectory(path: str, times: Sequence[float],
                         poses: Sequence[np.ndarray]) -> None:
    with open(path, "w") as f:
        for t, p in zip(times, poses):
            f.write(pose_to_tum_line(t, np.asarray(p)) + "\n")


def read_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (times (N,), poses (N,4,4))."""
    from scipy.spatial.transform import Rotation

    times, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) < 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
            T[:3, 3] = [tx, ty, tz]
            times.append(t)
            poses.append(T)
    return np.asarray(times), np.asarray(poses)


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


def rpe_rmse(est_times: np.ndarray, est_poses: np.ndarray,
             gt_times: np.ndarray, gt_poses: np.ndarray,
             delta: int = 1, max_dt: float = 0.02) -> float:
    """Relative pose (translational drift) RMSE over `delta`-frame intervals."""
    pairs = associate_by_time(est_times, gt_times, max_dt)
    if len(pairs) < delta + 1:
        return float("nan")
    errs = []
    for k in range(len(pairs) - delta):
        i0, j0 = pairs[k]
        i1, j1 = pairs[k + delta]
        d_est = np.linalg.inv(est_poses[i0]) @ est_poses[i1]
        d_gt = np.linalg.inv(gt_poses[j0]) @ gt_poses[j1]
        e = np.linalg.inv(d_gt) @ d_est
        errs.append(np.linalg.norm(e[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs))))
