"""Frozen copy of staticfusion_tpu_torch/fusion/backend.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Map backend orchestration, the `Reconstruction::fuseFrame` equivalent
(port of staticfusion_tpu/fusion/backend.py without the slot-routed
oracle `fuse_frame_slots`; reference Reconstruction.cpp:235-325).

Even index factors > 1 (the shipped default F=4) take the surfel-major
sparse fuse; other factors (the F=1 preset) the texel fuse, on a grid
routed down to QVGA rows above QVGA (`FusionConfig.route_factor`)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sfbench.reference.sf.config import CameraConfig, SFConfig
from sfbench.reference.sf.fusion import predict, sparse
from sfbench.reference.sf.fusion.association import associate_texels
from sfbench.reference.sf.fusion.clean import (kill_mask_from_tex,
                                                 window_kill_tex,
                                                 writeback_and_insert)
from sfbench.reference.sf.fusion.indexmap import predict_indices
from sfbench.reference.sf.fusion.surfels import SurfelMap
from sfbench.reference.sf.fusion.texelmap import project_surfels
from sfbench.reference.sf.fusion.update import apply_updates, merge_texels
from sfbench.reference.sf.geometry.se3 import se3_inverse, so3_log


def velocity_weighting(curr_pose: torch.Tensor, last_pose: torch.Tensor,
                       weight_multiplier: float,
                       config: SFConfig) -> torch.Tensor:
    """w = max(1 - min(max(|dt|, |dr|), cap)/cap, floor) * multiplier
    (Reconstruction.cpp:262-282)."""
    fus = config.fusion
    diff = se3_inverse(curr_pose) @ last_pose
    dt = torch.linalg.vector_norm(diff[:3, 3])
    dr = torch.linalg.vector_norm(so3_log(diff[:3, :3]))
    w = torch.clamp(torch.maximum(dt, dr), max=fus.velocity_weight_cap)
    return torch.clamp(1.0 - w / fus.velocity_weight_cap,
                       min=fus.velocity_weight_floor) * weight_multiplier


def effective_route_factor(config: SFConfig) -> int:
    """Resolved FusionConfig.route_factor (0 = auto: cap the texel-fuse
    grid at QVGA rows, so 1 at <= 240 rows and 2 at VGA)."""
    rf = config.fusion.route_factor
    if rf > 0:
        return rf
    return max(1, config.camera.height // 240)


def routed_config(config: SFConfig, rf: int) -> SFConfig:
    """The same config with the camera scaled 1/rf (the FOV-derived
    intrinsics scale with it) and routing off."""
    cam = config.camera
    return config.replace(
        camera=CameraConfig(width=cam.width // rf, height=cam.height // rf,
                            fovh_deg=cam.fovh_deg, fovv_deg=cam.fovv_deg),
        fusion=dataclasses.replace(config.fusion, route_factor=1))


class FuseResult(NamedTuple):
    smap: SurfelMap
    curr_pose: torch.Tensor
    pred: predict.PredictedView  # next frame's LOW-confidence view


def fuse_frame(smap: SurfelMap, curr_pose: torch.Tensor,
               T_odometry: torch.Tensor, raw_depth_m: torch.Tensor,
               filtered_depth_m: torch.Tensor, rgb: torch.Tensor,
               static_prob: torch.Tensor, tick: torch.Tensor,
               config: SFConfig) -> FuseResult:
    """One steady-state map update (Reconstruction.cpp:261-313).

    Even F > 1: the sparse fuse.  Otherwise, above QVGA rows (route
    factor rf > 1), the fuse runs on the 1/rf grid: strided picks of the
    inputs (exact-0 depth holes stay 0) at the scaled camera, whose
    centre sits half a native pixel off (about 2 mm at 2 m, below the
    sensor noise); the carried prediction is repeated back up to native
    resolution for the solver.  Else the texel fuse: render -> texel-routed
    association -> texel merge -> window kill on the merged texels ->
    write-back and insert -> the merged texels splatted as the next
    frame's prediction."""
    if sparse.supports_sparse(config):
        return fuse_frame_sparse(smap, curr_pose, T_odometry, raw_depth_m,
                                 filtered_depth_m, rgb, static_prob, tick,
                                 config)
    rf = effective_route_factor(config)
    if rf > 1:
        pick = lambda a: a[::rf, ::rf]
        res = fuse_frame(smap, curr_pose, T_odometry, pick(raw_depth_m),
                         pick(filtered_depth_m), pick(rgb),
                         pick(static_prob), tick, routed_config(config, rf))
        up = lambda a: a.repeat_interleave(rf, dim=0).repeat_interleave(
            rf, dim=1)
        return res._replace(pred=predict.PredictedView(
            *[up(a) for a in res.pred]))
    fus = config.fusion
    last_pose = curr_pose
    curr_pose = curr_pose @ T_odometry
    weighting = velocity_weighting(curr_pose, last_pose, 1.0, config)
    tex, local = predict_indices(smap, curr_pose, tick, config)
    upd, new = associate_texels(tex, raw_depth_m, filtered_depth_m, rgb,
                                static_prob, curr_pose, tick, weighting,
                                config)
    merged = merge_texels(tex, upd, tick)
    # The window test sees post-update attributes (the reference re-renders
    # before clean, Reconstruction.cpp:300).
    kill_tex = window_kill_tex(merged, tick, config)
    smap = writeback_and_insert(smap, merged, upd.has, kill_tex, local, new,
                                curr_pose, tick, config)
    # The next frame predicts at this pose: splat the surviving merged
    # texels with the LOW-confidence cull.
    pred_has = (merged.has & ~kill_tex & (merged.conf >= fus.low_conf)
                & (merged.z > fus.predict_z_min))
    pred = predict.splat_from_texels(merged._replace(has=pred_has), config)
    return FuseResult(smap=smap, curr_pose=curr_pose, pred=pred)


def fuse_frame_sparse(smap: SurfelMap, curr_pose: torch.Tensor,
                      T_odometry: torch.Tensor, raw_depth_m: torch.Tensor,
                      filtered_depth_m: torch.Tensor, rgb: torch.Tensor,
                      static_prob: torch.Tensor, tick: torch.Tensor,
                      config: SFConfig) -> FuseResult:
    """Surfel-major association on the F-resolution z-buffer -> slot-space
    merge -> `post_factor` render of the merged map for the clean window
    test and the prediction splat -> lifecycle + watermark insert.  At
    post factor == index factor the render reuses the association's
    z-buffer winners (sparse.materialize_from_winners)."""
    fus = config.fusion
    cfg1 = sparse.post_factor_config(config)
    last_pose = curr_pose
    curr_pose = curr_pose @ T_odometry
    weighting = velocity_weighting(curr_pose, last_pose, 1.0, config)
    local = project_surfels(smap, curr_pose, config)
    assoc = sparse.associate_sparse(smap, local, raw_depth_m,
                                    filtered_depth_m, rgb, static_prob,
                                    curr_pose, tick, weighting, config)
    merged_map = apply_updates(smap, assoc.updates, tick)
    if cfg1.fusion.index_factor == fus.index_factor:
        tex1 = sparse.materialize_from_winners(
            merged_map, project_surfels(merged_map, curr_pose, config),
            assoc.is_winner, assoc.flat, config)
    else:
        tex1, _ = predict_indices(merged_map, curr_pose, tick, cfg1)
    kill_tex = window_kill_tex(tex1, tick, cfg1)
    killed = kill_mask_from_tex(kill_tex, tex1.idx, merged_map.capacity,
                                0)
    smap_out = sparse.lifecycle_and_insert(merged_map, killed, assoc.new,
                                           tick, config)
    pred_has = (tex1.has & ~kill_tex & (tex1.conf >= fus.low_conf)
                & (tex1.z > fus.predict_z_min))
    pred = predict.splat_from_texels(tex1._replace(has=pred_has), cfg1)
    return FuseResult(smap=smap_out, curr_pose=curr_pose, pred=pred)
