"""Keyframe database, loop-closure detection and trajectory correction
(port of staticfusion_tpu/pipeline/keyframes.py).

The reference only logs its pose graph (Reconstruction.cpp:315); this layer
closes the loop:

* fingerprints are block statistics (mean intensity, mean and validity of
  depth per coarse cell), so a query is one (K, D) reduction on the device;
* the relative pose of a matched keyframe and the current frame comes from
  the coarse-to-fine joint solver (solver/runsolver.py) in its
  frame-to-frame form, seeded with `T_init` for wide baselines;
* the correction optimises the keyframe chain plus the loop constraint
  (parallel/posegraph.py::optimize_chain) and deforms the map piecewise
  rigidly: each surfel moves with the keyframe interval it was born in.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.geometry import se3
from staticfusion_tpu_torch.ops.pyramid import build_pyramid_pair
from staticfusion_tpu_torch.ops.warp import warp_images_gather
from staticfusion_tpu_torch.parallel import posegraph
from staticfusion_tpu_torch.solver.runsolver import run_solver

FP_GRID = (12, 16)  # coarse cells; divides QVGA (240x320) and VGA (480x640)


class KeyframeDB(NamedTuple):
    """Fixed-capacity keyframe store with a live count."""
    emb: torch.Tensor        # (K, D) fingerprints
    poses: torch.Tensor      # (K, 4, 4) world_T_kf at insertion time
    intensity: torch.Tensor  # (K, H, W) stored grayscale
    depth: torch.Tensor      # (K, H, W) stored raw depth, metres
    frame_idx: torch.Tensor  # (K,) int32 source frame number, -1 unused
    count: torch.Tensor      # int32 live keyframes


def fp_dim(grid: Tuple[int, int] = FP_GRID) -> int:
    return grid[0] * grid[1] * 3


def empty_db(capacity: int, rows: int, cols: int,
             grid: Tuple[int, int] = FP_GRID, device=None) -> KeyframeDB:
    return KeyframeDB(
        emb=torch.zeros((capacity, fp_dim(grid)), device=device),
        poses=torch.eye(4, device=device).repeat(capacity, 1, 1),
        intensity=torch.zeros((capacity, rows, cols), device=device),
        depth=torch.zeros((capacity, rows, cols), device=device),
        frame_idx=torch.full((capacity,), -1, dtype=torch.int32,
                             device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device))


def fingerprint(intensity: torch.Tensor, depth: torch.Tensor,
                grid: Tuple[int, int] = FP_GRID) -> torch.Tensor:
    """(D,) embedding: per cell the mean intensity (normalised over the
    frame), the mean valid depth over the frame's mean depth, and the valid
    fraction.  Invalid depth is exactly 0."""
    gh, gw = grid
    rows, cols = intensity.shape
    cells = lambda a: a.reshape(gh, rows // gh, gw, cols // gw)
    bi = cells(intensity).mean(dim=(1, 3))
    valid = (depth > 0.0).to(depth.dtype)
    vcells = cells(valid)
    vfrac = vcells.mean(dim=(1, 3))
    dsum = cells(depth).sum(dim=(1, 3))
    dmean = dsum / torch.clamp(vcells.sum(dim=(1, 3)), min=1.0)
    bi = (bi - bi.mean()) / (bi.std(correction=0) + 1e-6)
    dnorm = dmean / (torch.sum(dsum) / torch.clamp(torch.sum(valid), min=1.0)
                     + 1e-6)
    return torch.cat([bi.reshape(-1), dnorm.reshape(-1), vfrac.reshape(-1)])


def add_keyframe(db: KeyframeDB, intensity: torch.Tensor,
                 depth: torch.Tensor, pose: torch.Tensor,
                 frame_idx: int) -> KeyframeDB:
    """A new DB with the keyframe appended at `count`.  The caller keeps a
    slot free by halving the DB near capacity (`halve_db`); the clamp to
    the last slot is a safety, not an eviction policy."""
    K = db.emb.shape[0]
    k = torch.clamp(db.count.to(torch.int64), max=K - 1)

    def put(a, v):
        a = a.clone()
        a.index_copy_(0, k[None], v[None].to(a.dtype))
        return a
    return KeyframeDB(
        emb=put(db.emb, fingerprint(intensity, depth)),
        poses=put(db.poses, pose), intensity=put(db.intensity, intensity),
        depth=put(db.depth, depth),
        frame_idx=put(db.frame_idx, torch.tensor(frame_idx,
                                                 device=db.count.device)),
        count=torch.clamp(db.count + 1, max=K))


def halve_db(db: KeyframeDB) -> KeyframeDB:
    """Keep the even slots (keyframe 0, the gauge anchor, stays) and halve
    the count; the vacated rows' frame numbers become -1.  The caller
    doubles its keyframe stride at the same time, so a fixed-capacity DB
    spans any run length at a coarsening temporal resolution."""
    h = (db.emb.shape[0] + 1) // 2

    def take(a):
        a = a.clone()
        a[:h] = a[0::2].clone()
        return a
    frame_idx = take(db.frame_idx)
    frame_idx[h:] = -1
    return KeyframeDB(emb=take(db.emb), poses=take(db.poses),
                      intensity=take(db.intensity), depth=take(db.depth),
                      frame_idx=frame_idx,
                      count=torch.div(db.count + 1, 2, rounding_mode="floor"))


def query(db: KeyframeDB, emb: torch.Tensor, cur_frame_idx: int,
          min_gap: int, grid: Tuple[int, int] = FP_GRID,
          trim_keep: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_k, best_dist) device scalars: the nearest stored fingerprint
    at least `min_gap` frames older than `cur_frame_idx`; best_dist is +inf
    when none qualifies.  The distance is trimmed: squared differences are
    summed per cell (3 channels) and only the smallest `trim_keep`
    fraction of cells is averaged, so a moving object's cells drop out."""
    G = grid[0] * grid[1]
    idx = torch.arange(db.emb.shape[0], device=emb.device)
    eligible = (idx < db.count) & (db.frame_idx <= cur_frame_idx - min_gap)
    cell = ((db.emb - emb[None, :]) ** 2).reshape(-1, 3, G).sum(dim=1)
    keep = max(1, int(trim_keep * G))
    d2 = torch.mean(torch.sort(cell, dim=-1).values[:, :keep], dim=-1)
    d2 = torch.where(eligible, d2, torch.full_like(d2, float("inf")))
    best = torch.argmin(d2)
    return best, d2[best]


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries, the two middle values averaged at an
    even count (jnp.nanmedian; torch.nanmedian takes the lower one); NaN
    when there is none.  On the device: no host read."""
    v = torch.sort(x.reshape(-1)).values  # NaN sorts last
    n = torch.sum(~torch.isnan(v))
    last = v.shape[0] - 1
    lo = v[torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last)]
    hi = v[torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last)]
    return 0.5 * lo + 0.5 * hi


def relative_pose(kf_intensity: torch.Tensor, kf_depth: torch.Tensor,
                  intensity: torch.Tensor, depth: torch.Tensor,
                  config: SFConfig, T_init: torch.Tensor | None = None):
    """(T, residual): kf_T_cur from the frame-to-frame joint solver (raw
    depth on both sides, zero velocity prior, the steady kb so a mover
    cannot pull the constraint), and the median joint depth + 0.15
    photometric residual over the covisible pixels the solve labels
    static.  A pair whose static covisible share is under 25% gets +inf.
    Intensities are mean-normalised over that region first.  `T_init`
    seeds the solve (a wide baseline is outside its basin from
    identity)."""
    pred_pyr, cur_pyr = build_pyramid_pair(kf_depth, kf_intensity, depth,
                                           intensity, config)
    dev = depth.device
    sol = run_solver(cur_pyr, pred_pyr, torch.zeros(6, device=dev), config,
                     kb=config.solver.kb, T_init=T_init)
    warped = warp_images_gather(pred_pyr[0], cur_pyr[0].depth,
                                sol.T_odometry, config.camera.fovh)
    # The current frame's static pixels from the solve: clamp(b[label]),
    # invalid-cluster pixels static (buildSegmImage without the temporal
    # rescue).
    k = config.num_clusters
    b_ext = torch.cat([torch.clamp(sol.b_segm, 0.0, 1.0),
                       torch.ones(1, device=dev)])
    static = b_ext[torch.clamp(sol.clustering.labels[0].to(torch.int64), 0,
                               k)] > 0.5
    m = (warped.depth > 0.0) & (cur_pyr[0].depth > 0.0) & static
    covis = m.to(torch.float32)
    zero = torch.zeros((), device=dev)
    i_cur = cur_pyr[0].intensity
    i_wrp = warped.intensity
    n_covis = torch.clamp(torch.sum(covis), min=1.0)
    mean_cur = torch.sum(torch.where(m, i_cur, zero)) / n_covis
    mean_wrp = torch.sum(torch.where(m, i_wrp, zero)) / n_covis
    i_err = torch.abs(i_cur / torch.clamp(mean_cur, min=1e-6)
                      - i_wrp / torch.clamp(mean_wrp, min=1e-6))
    err = torch.abs(cur_pyr[0].depth - warped.depth) + 0.15 * i_err
    resid = nanmedian(torch.where(m, err, torch.full_like(err,
                                                          float("nan"))))
    frac = torch.sum(covis) / covis.numel()
    resid = torch.where(frac < 0.25, torch.full_like(resid, float("inf")),
                        resid)
    return sol.T_odometry, resid


def deform_map(smap, kf_frame_idx: torch.Tensor, old_poses: torch.Tensor,
               new_poses: torch.Tensor, n_kf: int):
    """Piecewise-rigid map correction after a pose-graph solve: each valid
    surfel takes the correction new @ inv(old) of the last keyframe born at
    or before its `init_time` (of the first `n_kf` rows of kf_frame_idx);
    surfels older than the first keyframe ride node 0, whose correction is
    identity (the graph is gauge-fixed there)."""
    delta = new_poses @ se3.se3_inverse(old_poses)              # (K, 4, 4)
    k = torch.arange(kf_frame_idx.shape[0], device=delta.device)
    keys = torch.where(k < n_kf, kf_frame_idx.to(torch.float32),
                       torch.full_like(delta[:, 0, 0], float("inf")))
    seg = torch.clamp(
        torch.searchsorted(keys, smap.init_time.contiguous(), right=True)
        - 1, 0, max(n_kf - 1, 0))
    D = delta[seg]                                              # (N, 4, 4)
    pos = torch.einsum("nij,nj->ni", D[:, :3, :3], smap.pos) + D[:, :3, 3]
    nrm = torch.einsum("nij,nj->ni", D[:, :3, :3], smap.normal)
    valid = smap.valid[:, None]
    return smap._replace(pos=torch.where(valid, pos, smap.pos),
                         normal=torch.where(valid, nrm, smap.normal))


def close_loop(kf_poses: torch.Tensor, n_kf: int, loop_i, loop_j,
               T_ij: torch.Tensor, loop_weight: float = 4.0,
               iters: int = 10) -> torch.Tensor:
    """(K, 4, 4) keyframe poses optimised against one loop constraint
    i_T_j: the chain k -> k+1 of the first n_kf rows contributes the
    composed odometry (rows past it are inactive), gauge-fixed at pose 0.
    The layout (slots [0, K-1) the ordered chain, then the loop) is
    posegraph.optimize_chain's."""
    K = kf_poses.shape[0]
    dev = kf_poses.device
    ks = torch.arange(K - 1, device=dev)
    g = posegraph.empty_graph(K, K + 1, device=dev)
    ci, cj, cT, cw = g.ci.clone(), g.cj.clone(), g.cT.clone(), g.cw.clone()
    ci[:K - 1] = ks
    cj[:K - 1] = ks + 1
    cT[:K - 1] = se3.se3_inverse(kf_poses[:-1]) @ kf_poses[1:]
    cw[:K - 1] = (ks < n_kf - 1).to(kf_poses.dtype)
    g = g._replace(poses=kf_poses,
                   n_poses=torch.tensor(n_kf, dtype=torch.int32, device=dev),
                   ci=ci, cj=cj, cT=cT, cw=cw,
                   n_constraints=torch.tensor(K - 1, dtype=torch.int32,
                                              device=dev))
    g = posegraph.add_constraint(g, loop_i, loop_j, T_ij, loop_weight)
    return posegraph.optimize_chain(g, iters=iters).poses
