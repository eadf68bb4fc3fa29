"""Keyframe pose-graph optimisation (port of
staticfusion_tpu/parallel/posegraph.py).

Gauss-Newton on SE(3) over fixed-capacity constraint arrays: right
perturbations xi_i of each pose, residual r = log(Z^-1 T_i^-1 T_j), the
adjoint Jacobians, the first pose gauge-fixed.  `optimize` solves the dense
6M x 6M normal equations (any graph); `optimize_chain` solves the
odometry-chain + loop layout of `keyframes.close_loop` in O(M) 6x6 block
steps (block-tridiagonal Thomas + Woodbury).  Float32 throughout, as the
JAX package computes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from staticfusion_tpu_torch.geometry import se3


class PoseGraph(NamedTuple):
    poses: torch.Tensor      # (M, 4, 4) keyframe poses (world_T_kf)
    n_poses: torch.Tensor    # int32
    ci: torch.Tensor         # (C,) int64 constraint source index
    cj: torch.Tensor         # (C,) int64 constraint target index
    cT: torch.Tensor         # (C, 4, 4) measured i_T_j
    cw: torch.Tensor         # (C,) weight (0 = inactive)
    n_constraints: torch.Tensor  # int32


def empty_graph(max_poses: int, max_constraints: int,
                device=None) -> PoseGraph:
    eye = torch.eye(4, device=device)
    return PoseGraph(
        poses=eye.repeat(max_poses, 1, 1),
        n_poses=torch.tensor(0, dtype=torch.int32, device=device),
        ci=torch.zeros(max_constraints, dtype=torch.int64, device=device),
        cj=torch.zeros(max_constraints, dtype=torch.int64, device=device),
        cT=eye.repeat(max_constraints, 1, 1),
        cw=torch.zeros(max_constraints, device=device),
        n_constraints=torch.tensor(0, dtype=torch.int32, device=device))


def add_pose(g: PoseGraph, pose: torch.Tensor) -> PoseGraph:
    """The graph with `pose` in slot n_poses (a host-side index)."""
    poses = g.poses.clone()
    poses[int(g.n_poses)] = pose
    return g._replace(poses=poses, n_poses=g.n_poses + 1)


def add_constraint(g: PoseGraph, i, j, T_ij: torch.Tensor,
                   weight: float = 1.0) -> PoseGraph:
    """The graph with constraint i_T_j of `weight` in slot n_constraints
    (a host-side index)."""
    k = int(g.n_constraints)
    ci, cj, cT, cw = g.ci.clone(), g.cj.clone(), g.cT.clone(), g.cw.clone()
    ci[k], cj[k], cT[k], cw[k] = i, j, T_ij, weight
    return g._replace(ci=ci, cj=cj, cT=cT, cw=cw,
                      n_constraints=g.n_constraints + 1)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint in the (v, w) twist layout: (..., 4, 4) -> (..., 6, 6)."""
    R = T[..., :3, :3]
    tR = se3.hat3(T[..., :3, 3]) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _residuals_and_jacobians(g: PoseGraph):
    """Per-constraint residual r = log(Z^-1 Ti^-1 Tj) and the Jacobians
    with respect to right perturbations of Ti and Tj: J_j = I (first
    order), J_i = -Ad(Tj^-1 Ti)."""
    Ti = g.poses[g.ci]
    Tj = g.poses[g.cj]
    E = se3.se3_inverse(g.cT) @ se3.se3_inverse(Ti) @ Tj
    r = se3.se3_log(E)                                     # (C, 6)
    Jj = torch.eye(6, dtype=r.dtype, device=r.device).expand(
        r.shape[0], 6, 6)
    Ji = -_adjoint(se3.se3_inverse(Tj) @ Ti)
    return r, Ji, Jj


def _normal_equations(poses: torch.Tensor, ci: torch.Tensor,
                      cj: torch.Tensor, cT: torch.Tensor, cw: torch.Tensor):
    """(H (M, 6, M, 6), b (M, 6)) of the constraint set.  Constraints may
    share poses, so every add accumulates."""
    M = poses.shape[0]
    g_view = PoseGraph(poses=poses, n_poses=None, ci=ci, cj=cj, cT=cT,
                       cw=cw, n_constraints=None)
    r, Ji, Jj = _residuals_and_jacobians(g_view)
    JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    w = cw[:, None, None]
    Hij = w * (JiT @ Jj)
    # Blocks as (row pose, column pose, 6, 6), permuted to (M, 6, M, 6).
    H = torch.zeros((M, M, 6, 6), dtype=poses.dtype, device=poses.device)
    H.index_put_((ci, ci), w * (JiT @ Ji), accumulate=True)
    H.index_put_((cj, cj), w * (JjT @ Jj), accumulate=True)
    H.index_put_((ci, cj), Hij, accumulate=True)
    H.index_put_((cj, ci), Hij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((M, 6), dtype=poses.dtype, device=poses.device)
    b.index_add_(0, ci, cw[:, None] * torch.einsum("cab,cb->ca", JiT, r))
    b.index_add_(0, cj, cw[:, None] * torch.einsum("cab,cb->ca", JjT, r))
    return H.permute(0, 2, 1, 3), b


def _gn_update(poses: torch.Tensor, H: torch.Tensor, b: torch.Tensor,
               damping: float) -> torch.Tensor:
    M = poses.shape[0]
    Hm = H.reshape(M * 6, M * 6)
    # Gauge fix pose 0 + damp everything (pins untouched poses too).
    gauge = torch.zeros(M * 6, dtype=poses.dtype, device=poses.device)
    gauge[:6] = 1e6
    Hm = Hm + torch.diag(gauge + damping + 1e-8)
    dx = torch.linalg.solve_ex(Hm, -b.reshape(M * 6)).result.reshape(M, 6)
    return poses @ se3.se3_exp(dx)


def optimize(g: PoseGraph, iters: int = 10,
             damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton with gauge fix on pose 0, through the dense normal
    equations.  Inactive constraints carry zero weight; inactive poses are
    pinned by the damping term."""
    for _ in range(iters):
        H, b = _normal_equations(g.poses, g.ci, g.cj, g.cT, g.cw)
        g = g._replace(poses=_gn_update(g.poses, H, b, damping))
    return g


def optimize_sharded(g: PoseGraph, mesh, axis: str = "world",
                     iters: int = 10, damping: float = 1e-6) -> PoseGraph:
    """Distributed Gauss-Newton: each rank of `mesh`'s `axis` forms the
    normal equations of its block of constraints, a SUM all-reduce
    combines H and b, and the (small, dense) 6M x 6M solve runs
    replicated.  Equal to `optimize` up to float addition order.  The
    constraint count must divide by the axis size; pad with zero-weight
    constraints (`empty_graph` slots are zero-weight already)."""
    n = mesh.axis_size(axis)
    C = g.ci.shape[0]
    if C % n:
        raise ValueError(f"{C} constraints do not divide over {n} ranks")
    lo = C // n * mesh.axis_index(axis)
    part = lambda a: a[lo:lo + C // n]
    mesh.note("constraints", C, C // n)
    for _ in range(iters):
        H, b = _normal_equations(g.poses, part(g.ci), part(g.cj),
                                 part(g.cT), part(g.cw))
        M = H.shape[0]
        hb = mesh.all_reduce(torch.cat([H.reshape(-1), b.reshape(-1)]),
                             "sum", axis)
        H, b = hb[:M * 6 * M * 6].reshape(H.shape), hb[M * 6 * M * 6:]
        g = g._replace(poses=_gn_update(g.poses, H, b.reshape(M, 6),
                                        damping))
    return g


def _solve_block_tridiag(diag: torch.Tensor, offd: torch.Tensor,
                         B: torch.Tensor) -> torch.Tensor:
    """Solve the block-tridiagonal system T X = B by block-Thomas
    elimination (one 6x6 step per chain node, forward then back).

    diag: (M, 6, 6) diagonal blocks D_k (SPD after gauge and damping);
    offd: (M, 6, 6) super-diagonal blocks U_k = T[k, k+1] (row M-1 unused);
    B:    (M, 6, R) right-hand sides, solved together.
    The `_ex` solvers skip the host-side error check (no device sync).
    """
    M = diag.shape[0]
    c = torch.eye(6, dtype=diag.dtype, device=diag.device)
    y = torch.zeros_like(B[0])
    cs, ys = [], []
    for k in range(M):
        Up = offd[k - 1] if k > 0 else torch.zeros_like(offd[0])
        L = Up.T @ torch.linalg.inv_ex(c).inverse
        c = diag[k] - L @ Up
        y = B[k] - L @ y
        cs.append(c)
        ys.append(y)
    x = torch.linalg.solve_ex(cs[M - 1], ys[M - 1]).result
    xs = [x]
    for k in range(M - 2, -1, -1):
        x = torch.linalg.solve_ex(cs[k], ys[k] - offd[k] @ x).result
        xs.append(x)
    return torch.stack(xs[::-1])


def optimize_chain(g: PoseGraph, iters: int = 10,
                   damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton over the odometry-chain + sparse-loop layout.

    Constraint slots [0, M-1) must be the ordered chain k -> k+1 (slot k
    connects poses k and k+1; zero-weight slots are inactive); the
    remaining L slots are arbitrary (i, j) loop constraints.  The Hessian
    is then block-tridiagonal T plus a rank-6L update V^T V, and each step
    solves exactly by block-Thomas and the Woodbury identity:

        dx = -[T^-1 b  -  T^-1 V^T (I + V T^-1 V^T)^-1 V T^-1 b]

    The layout is checked on the host (a ValueError names the first bad
    slot): the tridiagonal part is built from slot positions, so a graph
    that breaks it would get a wrong Hessian, not an error."""
    M = g.poses.shape[0]
    L = g.ci.shape[0] - (M - 1)
    if L < 0:
        raise ValueError(f"constraint capacity {g.ci.shape[0]} below the "
                         f"chain length {M - 1}")
    dev, dt = g.poses.device, g.poses.dtype
    ks = torch.arange(M - 1, device=dev)
    bad = (g.ci[:M - 1] != ks) | (g.cj[:M - 1] != ks + 1)
    if bool(bad.any()):
        k = int(torch.nonzero(bad)[0])
        raise ValueError(
            f"optimize_chain: slot {k} links poses {int(g.ci[k])} -> "
            f"{int(g.cj[k])}; slots [0, {M - 1}) must be the chain k -> k+1")
    li, lj = g.ci[M - 1:], g.cj[M - 1:]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    gauge = torch.zeros(M, dtype=dt, device=dev)
    gauge[0] = 1e6
    ridge = (gauge + damping + 1e-8)[:, None, None] * eye6
    for _ in range(iters):
        r, Ji, Jj = _residuals_and_jacobians(g)
        w = g.cw[:, None, None]
        JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)

        # Chain part -> block tridiagonal T (+ gauge + damping) and b.
        c = slice(0, M - 1)
        diag = torch.zeros((M, 6, 6), dtype=dt, device=dev)
        diag[:M - 1] += (w * (JiT @ Ji))[c]
        diag[1:] += (w * (JjT @ Jj))[c]
        diag = diag + ridge
        offd = torch.cat([(w * (JiT @ Jj))[c],
                          torch.zeros((1, 6, 6), dtype=dt, device=dev)])
        cw2 = g.cw[c, None]
        b = torch.zeros((M, 6), dtype=dt, device=dev)
        b[:M - 1] += cw2 * torch.einsum("cab,cb->ca", JiT[c], r[c])
        b[1:] += cw2 * torch.einsum("cab,cb->ca", JjT[c], r[c])

        if L > 0:
            # Loop part: rows of V are sqrt(w) [.. Ji .. Jj ..]; b gets the
            # whole loop gradient, T none (it lives in V^T V).  Loop slots
            # may share poses, so the adds accumulate.
            sw = torch.sqrt(torch.clamp(g.cw[M - 1:], min=0.0))
            Vi = sw[:, None, None] * Ji[M - 1:]               # (L, 6, 6)
            Vj = sw[:, None, None] * Jj[M - 1:]
            rl = sw[:, None] * r[M - 1:]                      # (L, 6)
            b.index_add_(0, li, torch.einsum(
                "lab,lb->la", Vi.transpose(-1, -2), rl))
            b.index_add_(0, lj, torch.einsum(
                "lab,lb->la", Vj.transpose(-1, -2), rl))
            # Dense V^T as (M, 6, 6L), so its columns ride the tridiagonal
            # solve next to b.
            ar = torch.arange(L, device=dev)
            Vt = torch.zeros((M, L, 6, 6), dtype=dt, device=dev)
            Vt.index_put_((li, ar), Vi.transpose(-1, -2), accumulate=True)
            Vt.index_put_((lj, ar), Vj.transpose(-1, -2), accumulate=True)
            Vt = Vt.permute(0, 2, 1, 3).reshape(M, 6, 6 * L)
            X = _solve_block_tridiag(diag, offd,
                                     torch.cat([b[:, :, None], Vt], dim=-1))
            Tb, TVt = X[:, :, 0], X[:, :, 1:]          # (M, 6), (M, 6, 6L)

            def applyV(Y):                             # (M, 6, R) -> (6L, R)
                return (torch.einsum("lab,lbr->lar", Vi, Y[li])
                        + torch.einsum("lab,lbr->lar", Vj, Y[lj])
                        ).reshape(6 * L, -1)

            S = torch.eye(6 * L, dtype=dt, device=dev) + applyV(TVt)
            u = applyV(Tb[:, :, None])[:, 0]
            dx = -(Tb - TVt @ torch.linalg.solve_ex(S, u).result)
        else:
            dx = -_solve_block_tridiag(diag, offd, b[:, :, None])[:, :, 0]
        g = g._replace(poses=g.poses @ se3.se3_exp(dx))
    return g


def chain_odometry_graph(poses, odometry, weights=None, max_poses=None,
                         max_constraints=None, device=None) -> PoseGraph:
    """A graph from a trajectory + frame-to-frame odometry list (4x4
    arrays or tensors): constraint k links poses k -> k+1."""
    n = len(poses)
    max_poses = max_poses or n
    max_constraints = max_constraints or (2 * n)
    g = empty_graph(max_poses, max_constraints, device=device)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    for p in poses:
        g = add_pose(g, t(p))
    for k, T in enumerate(odometry):
        w = 1.0 if weights is None else weights[k]
        g = add_constraint(g, k, k + 1, t(T), w)
    return g
