"""The per-frame SLAM step (port of staticfusion_tpu/pipeline/step.py):
`bootstrap_step` for frames 0+1 (StaticFusion-datasets.cpp:108-144) and
`slam_step` for the steady state: predict -> solve -> temporal check ->
segment -> fuse.

Both take an optional `mesh` (parallel/mesh.py).  With one, the frames
and the state are this rank's blocks in the layout of
`mesh.state_shardings`: image rows over `pix`, surfel slots over `map`.
The frame and the carried images are all-gathered over `pix` (the depth
filter, the pyramid, the warps and the fuse's stencils run on whole
images), the per-pixel stages divide by rows and the per-surfel passes by
slots; the outputs are whole on every rank (parallel/sharded.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion import backend, predict, surfels
from staticfusion_tpu_torch.ops import bilateral
from staticfusion_tpu_torch.ops.pyramid import build_pyramid_pair
from staticfusion_tpu_torch.parallel.mesh import (gather_images, local_rows,
                                                  map_sum)
from staticfusion_tpu_torch.pipeline.state import (RingBuffers, SlamState,
                                                   init_state)
from staticfusion_tpu_torch.pipeline.temporal import \
    compute_temporal_residuals
from staticfusion_tpu_torch.solver.runsolver import run_solver
from staticfusion_tpu_torch.solver.segmentation import build_segm_image


class Frame(NamedTuple):
    """One input RGB-D frame at solver resolution."""
    rgb: torch.Tensor       # (H, W, 3) float [0,1]
    depth_mm: torch.Tensor  # (H, W) float carrying u16 millimetres


class StepOutputs(NamedTuple):
    curr_pose: torch.Tensor     # (4,4) global pose after this frame
    T_odometry: torch.Tensor    # (4,4) frame-to-frame
    static_prob: torch.Tensor   # (H, W)
    labels: torch.Tensor        # (H, W) cluster labels
    b_segm: torch.Tensor        # (K,)
    surfel_count: torch.Tensor  # int32
    dense: torch.Tensor         # bool — prediction dense enough
    ddt_sum: torch.Tensor       # sum(ddt) — trajectory-write gate


def _intensity(rgb: torch.Tensor) -> torch.Tensor:
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _preprocess(frame: Frame, config: SFConfig):
    """Bilateral + metricise (Reconstruction.cpp:327-346): (raw_m, filt_m)."""
    return bilateral.preprocess_depth_mm(frame.depth_mm,
                                         config.fusion.depth_max)


def _store_ring(rings: RingBuffers, slot, depth, intensity,
                odom) -> RingBuffers:
    out = RingBuffers(*[r.clone() for r in rings])
    out.depth[slot] = depth
    out.intensity[slot] = intensity
    out.odom[slot] = odom
    return out


def _whole_frame(frame: Frame, config: SFConfig, mesh) -> Frame:
    return Frame(*gather_images(frame, mesh, config.rows))


def _local_images(state: SlamState, mesh) -> SlamState:
    """The state with every image cut to this rank's row block."""
    if mesh is None:
        return state
    rows = lambda a, dim=0: local_rows(a, mesh, dim).contiguous()
    return state._replace(
        rings=state.rings._replace(depth=rows(state.rings.depth, 1),
                                   intensity=rows(state.rings.intensity, 1)),
        prev_rgb=rows(state.prev_rgb),
        prev_filt_depth=rows(state.prev_filt_depth),
        prev_static_prob=rows(state.prev_static_prob),
        pred=type(state.pred)(*[rows(a) for a in state.pred]))


def bootstrap_step(frame0: Frame, frame1: Frame, initial_pose: torch.Tensor,
                   config: SFConfig, mesh=None):
    """Frames 0 and 1: raw-depth solve with the lenient kb, then the map
    from frame 1 at initial_pose @ T_odometry.  Returns (state, outputs).
    Under a mesh the map is this rank's slot block of the initial map
    (whose capacity `mesh.n_map` must divide)."""
    frame0 = _whole_frame(frame0, config, mesh)
    frame1 = _whole_frame(frame1, config, mesh)
    dev = frame1.depth_mm.device
    state = init_state(config, dev)
    depth0 = frame0.depth_mm / 1000.0
    intens0 = _intensity(frame0.rgb)
    depth1 = frame1.depth_mm / 1000.0
    intens1 = _intensity(frame1.rgb)
    pred_pyr, cur_pyr = build_pyramid_pair(depth0, intens0, depth1, intens1,
                                           config)
    sol = run_solver(cur_pyr, pred_pyr, state.twist_old, config,
                     kb=config.solver.kb_bootstrap, mesh=mesh)
    static_prob = build_segm_image(sol.clustering.labels[0], sol.b_segm,
                                   state.per_cluster_residual, config, mesh)
    raw_m, filt_m = _preprocess(frame1, config)
    pose = initial_pose @ sol.T_odometry
    # The initial map is sized at the pixel count; the host grows it in
    # tiers as it fills (SlamSystem._maybe_resize_map).  Under routed
    # fusion the map is made from the routed grid, at the steady state's
    # surfel density.
    rf = backend.effective_route_factor(config)
    cfg_map = backend.routed_config(config, rf) if rf > 1 else config
    pick = lambda a: a[::rf, ::rf]
    cap0 = min(config.fusion.capacity,
               surfels.next_tier(pick(frame1.depth_mm).numel()))
    smap = surfels.initialise_map(cap0, pick(raw_m), pick(filt_m),
                                  pick(frame1.rgb), pick(static_prob), pose,
                                  cfg_map, mesh)
    rings = _store_ring(state.rings, 0, depth0, intens0,
                        torch.eye(4, device=dev))
    rings = _store_ring(rings, 1, depth1, intens1, sol.T_odometry)
    tick = torch.tensor(2, dtype=torch.int32, device=dev)
    pred_low = predict.predict_low_view(smap, pose, tick, config, mesh)
    state = _local_images(state._replace(
        smap=smap, curr_pose=pose, pred=pred_low, tick=tick,
        im_count=torch.tensor(1, dtype=torch.int32, device=dev),
        twist_old=sol.twist_old_next, rings=rings, prev_rgb=frame1.rgb,
        prev_filt_depth=filt_m, prev_static_prob=static_prob), mesh)
    out = StepOutputs(curr_pose=pose, T_odometry=sol.T_odometry,
                      static_prob=static_prob,
                      labels=sol.clustering.labels[0], b_segm=sol.b_segm,
                      surfel_count=map_sum(smap.count(), mesh),
                      dense=torch.zeros((), dtype=torch.bool, device=dev),
                      ddt_sum=torch.sum(sol.ddt_full))
    return state, out


def slam_step(state: SlamState, frame: Frame, config: SFConfig, mesh=None):
    """One steady-state frame.  Returns (state, outputs)."""
    local_rgb = frame.rgb
    # Under a mesh one all-gather brings the frame and the carried images
    # whole (the rings' oldest frame follows in the temporal check).
    whole = gather_images(tuple(frame) + tuple(state.pred)
                          + (state.prev_filt_depth, state.prev_rgb,
                             state.prev_static_prob), mesh, config.rows)
    frame = Frame(*whole[:2])
    pred = type(state.pred)(*whole[2:9])
    prev_filt_depth, prev_rgb, prev_static_prob = whole[9:]
    raw_m, filt_m = _preprocess(frame, config)
    intensity_cur = _intensity(frame.rgb)
    im_count = state.im_count + 1

    # Composite the view carried from the last fuse (with the previous
    # frame's uploads for the FillIn raw fallback).
    prediction = predict.composite_prediction(
        pred, prev_filt_depth, prev_rgb, prev_static_prob, config)
    # kb warm-up: the first steady frame uses the lenient kb unless the
    # model is already dense (StaticFusion-datasets.cpp:156-165).  kb stays
    # a device scalar.
    first_steady = state.im_count == 1
    kb = torch.where(first_steady & ~prediction.dense,
                     torch.tensor(config.solver.kb_bootstrap,
                                  device=raw_m.device),
                     torch.tensor(config.solver.kb, device=raw_m.device))

    pred_pyr, cur_pyr = build_pyramid_pair(
        prediction.depth, prediction.intensity, filt_m, intensity_cur, config)
    sol = run_solver(cur_pyr, pred_pyr, state.twist_old, config, kb=kb,
                     mesh=mesh)

    per_cluster = compute_temporal_residuals(
        state.rings, sol.T_odometry, im_count, filt_m, intensity_cur,
        sol.clustering.labels[0], config, mesh)
    ring_full = im_count >= config.buffer_length
    per_cluster = torch.where(ring_full, per_cluster,
                              torch.full_like(per_cluster, float("nan")))
    static_prob = build_segm_image(sol.clustering.labels[0], sol.b_segm,
                                   per_cluster, config, mesh)
    fused = backend.fuse_frame(state.smap, state.curr_pose, sol.T_odometry,
                               raw_m, filt_m, frame.rgb, static_prob,
                               state.tick, config, mesh)
    rows = lambda a: local_rows(a, mesh)
    rings = _store_ring(state.rings,
                        torch.remainder(im_count, config.buffer_length).long(),
                        rows(filt_m), rows(intensity_cur), sol.T_odometry)
    new_state = state._replace(
        smap=fused.smap, curr_pose=fused.curr_pose,
        pred=type(fused.pred)(*[rows(a) for a in fused.pred]),
        tick=state.tick + 1, im_count=im_count,
        twist_old=sol.twist_old_next, rings=rings, prev_rgb=local_rgb,
        prev_filt_depth=rows(filt_m), prev_static_prob=rows(static_prob),
        per_cluster_residual=per_cluster)
    out = StepOutputs(curr_pose=fused.curr_pose, T_odometry=sol.T_odometry,
                      static_prob=static_prob,
                      labels=sol.clustering.labels[0], b_segm=sol.b_segm,
                      surfel_count=map_sum(fused.smap.count(), mesh),
                      dense=prediction.dense,
                      ddt_sum=torch.sum(sol.ddt_full))
    return new_state, out
