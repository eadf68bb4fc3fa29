"""Geometric K-means clustering of the depth image (port of
staticfusion_tpu/solver/clustering.py; reference KMeans.cpp).  All 24
distances are evaluated at once (the reference's triangle-inequality
pruning gives the same exact nearest centre); Lloyd runs a fixed trip
count with a convergence mask; invalid pixels get label NUM_CLUSTERS."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from staticfusion_tpu_torch.config import NUM_CLUSTERS, SFConfig
from staticfusion_tpu_torch.ops.pyramid import Pyramid


class Clustering(NamedTuple):
    centers: torch.Tensor            # (3, K) — (depth, x, y) per cluster
    labels: Tuple[torch.Tensor, ...]  # per pyramid level, int64, K = invalid
    connectivity: torch.Tensor       # (K, K) bool, symmetric, diag True


def _seed_positions(rows_km: int, cols_km: int):
    """Image-plane seed grid (KMeans.cpp:76-84)."""
    k = NUM_CLUSTERS
    vert_div = math.ceil(math.sqrt(k))
    u_div = cols_km / (k + 1)
    v_div = rows_km / (vert_div + 1)
    return ([round((i + 1) * u_div) for i in range(k)],
            [round((i % vert_div + 1) * v_div) for i in range(k)])


def initialize_centers(depth: torch.Tensor, fovh: float) -> torch.Tensor:
    """Initial (depth, x, y) centres from the seed grid and each seed
    region's upper-median depth (KMeans.cpp:86-134)."""
    rows_km, cols_km = depth.shape
    k = NUM_CLUSTERS
    dev = depth.device
    u_list, v_list = _seed_positions(rows_km, cols_km)
    u_label = torch.tensor(u_list, dtype=torch.float32, device=dev)
    v_label = torch.tensor(v_list, dtype=torch.float32, device=dev)
    vv = torch.arange(rows_km, dtype=torch.float32, device=dev)[:, None]
    uu = torch.arange(cols_km, dtype=torch.float32, device=dev)[None, :]
    d2 = (vv[..., None] - v_label) ** 2 + (uu[..., None] - u_label) ** 2
    seed_label = torch.argmin(d2, dim=-1)
    flat_label = torch.where(depth != 0.0, seed_label,
                             torch.full_like(seed_label, k)).reshape(-1)
    member = flat_label[None, :] == torch.arange(k, device=dev)[:, None]
    masked = torch.where(member, depth.reshape(-1)[None, :],
                         torch.full_like(member, float("inf"),
                                         dtype=depth.dtype))
    sorted_d = torch.sort(masked, dim=1).values
    counts = torch.sum(member, dim=1)
    med = torch.gather(sorted_d, 1, (counts // 2)[:, None])[:, 0]
    med = torch.where(counts > 0, med, torch.zeros_like(med))
    inv_f = 2.0 * math.tan(0.5 * fovh) / float(cols_km)
    cx = (u_label - 0.5 * (cols_km - 1)) * med * inv_f
    cy = (v_label - 0.5 * (rows_km - 1)) * med * inv_f
    return torch.stack([med, cx, cy], dim=0)


def _assign(points: torch.Tensor, valid: torch.Tensor,
            centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centre labels; invalid pixels -> NUM_CLUSTERS."""
    diff = points[..., None] - centers[None, None, :, :]
    lbl = torch.argmin(torch.sum(diff * diff, dim=-2), dim=-1)
    return torch.where(valid, lbl, torch.full_like(lbl, NUM_CLUSTERS))


def lloyd_iterate(depth, xx, yy, centers0, iters: int, tol: float):
    """Fixed-trip Lloyd iterations with convergence masking
    (KMeans.cpp:167-228); empty clusters collapse to the origin."""
    valid = depth != 0.0
    pts = torch.stack([depth, xx, yy], dim=-1)
    flat_pts = pts.reshape(-1, 3)
    ks = torch.arange(NUM_CLUSTERS, device=depth.device)
    centers = centers0
    done = torch.zeros((), dtype=torch.bool, device=depth.device)
    for _ in range(iters - 1):
        lbl = _assign(pts, valid, centers).reshape(-1)
        w = (lbl[:, None] == ks[None, :]).to(depth.dtype)
        sums = w.T @ flat_pts
        counts = torch.sum(w, dim=0)
        new_centers = torch.where(counts[:, None] > 0,
                                  sums / torch.clamp(counts[:, None], min=1.0),
                                  torch.zeros_like(sums)).T
        max_diff = torch.max(torch.abs(centers - new_centers))
        centers = torch.where(done, centers, new_centers)
        done = done | (max_diff < tol)
    return centers


def compute_connectivity(depth, xx, yy, labels) -> torch.Tensor:
    """(K, K) bool adjacency from label changes across 4-neighbour edges
    with a 3D distance gate (KMeans.cpp:297-341)."""
    rows = depth.shape[0]
    thr2 = (0.03 * 120.0 / float(rows)) ** 2
    l0, ld, lr = labels[:-1, :-1], labels[1:, :-1], labels[:-1, 1:]
    d0, dd, dr = depth[:-1, :-1], depth[1:, :-1], depth[:-1, 1:]
    y0, yd = yy[:-1, :-1], yy[1:, :-1]
    x0, xr = xx[:-1, :-1], xx[:-1, 1:]
    valid0 = d0 != 0.0
    conn_v = (valid0 & (l0 != ld) & (ld != NUM_CLUSTERS)
              & (((d0 - dd) ** 2 + (y0 - yd) ** 2) < thr2))
    conn_h = (valid0 & (l0 != lr) & (lr != NUM_CLUSTERS)
              & (((d0 - dr) ** 2 + (x0 - xr) ** 2) < thr2))
    k = NUM_CLUSTERS
    ks = torch.arange(k, device=depth.device)[None, :]
    la = torch.cat([l0.reshape(-1), l0.reshape(-1)])
    lb = torch.cat([ld.reshape(-1), lr.reshape(-1)])
    m = torch.cat([conn_v.reshape(-1), conn_h.reshape(-1)])
    oh_a = ((la[:, None] == ks) & m[:, None]).to(torch.float32)
    oh_b = (lb[:, None] == ks).to(torch.float32)
    cnt = oh_a.T @ oh_b
    eye = torch.eye(k, dtype=torch.bool, device=depth.device)
    return ((cnt + cnt.T) > 0) | eye


def kmeans_level_for(config: SFConfig) -> int:
    """Pyramid level of the Lloyd iterations: `kmeans_level`, or (-1)
    the shallowest level with <= 120 rows."""
    lvl = config.solver.kmeans_level
    if lvl >= 0:
        return min(lvl, config.ctf_levels - 1)
    l = 1
    while (config.camera.height >> l) > 120 and l < config.ctf_levels - 1:
        l += 1
    return l


def cluster_frame(pyr: Pyramid, config: SFConfig) -> Clustering:
    """Init at the K-means level, Lloyd-iterate, label every level with the
    final centres, compute connectivity."""
    half = pyr[kmeans_level_for(config)]
    centers0 = initialize_centers(half.depth, config.camera.fovh)
    centers = lloyd_iterate(half.depth, half.xx, half.yy, centers0,
                            config.solver.kmeans_iters,
                            config.solver.kmeans_tol)
    labels = tuple(
        _assign(torch.stack([p.depth, p.xx, p.yy], dim=-1), p.depth != 0.0,
                centers) for p in pyr)
    conn = compute_connectivity(pyr[0].depth, pyr[0].xx, pyr[0].yy, labels[0])
    return Clustering(centers=centers, labels=labels, connectivity=conn)
