"""Map backend orchestration, the `Reconstruction::fuseFrame` equivalent
(port of staticfusion_tpu/fusion/backend.py; reference
Reconstruction.cpp:235-325).  Only the surfel-major sparse fuse (even
index factors > 1, the shipped default) is ported; other configurations
raise."""

from __future__ import annotations

from typing import NamedTuple

import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion import predict, sparse
from staticfusion_tpu_torch.fusion.clean import (kill_mask_from_tex,
                                                 window_kill_tex)
from staticfusion_tpu_torch.fusion.indexmap import predict_indices
from staticfusion_tpu_torch.fusion.surfels import SurfelMap
from staticfusion_tpu_torch.fusion.texelmap import project_surfels
from staticfusion_tpu_torch.fusion.update import apply_updates
from staticfusion_tpu_torch.geometry.se3 import se3_inverse, so3_log


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
    """Resolved FusionConfig.route_factor (0 = auto: 1 at <= 240 rows)."""
    rf = config.fusion.route_factor
    if rf > 0:
        return rf
    return max(1, config.camera.height // 240)


class FuseResult(NamedTuple):
    smap: SurfelMap
    curr_pose: torch.Tensor
    pred: predict.PredictedView  # next frame's LOW-confidence view


def check_supported(config: SFConfig) -> None:
    """Raise for configurations whose fuse path is not ported."""
    if not sparse.supports_sparse(config):
        raise NotImplementedError(
            "the PyTorch port implements only the sparse fuse (even "
            f"index_factor > 1); got index_factor="
            f"{config.fusion.index_factor}")
    if effective_route_factor(config) != 1:
        raise NotImplementedError("routed fusion is not ported")


def fuse_frame(smap: SurfelMap, curr_pose: torch.Tensor,
               T_odometry: torch.Tensor, raw_depth_m: torch.Tensor,
               filtered_depth_m: torch.Tensor, rgb: torch.Tensor,
               static_prob: torch.Tensor, tick: torch.Tensor,
               config: SFConfig) -> FuseResult:
    """One steady-state map update (Reconstruction.cpp:261-313): the
    surfel-major sparse fuse."""
    check_supported(config)
    return fuse_frame_sparse(smap, curr_pose, T_odometry, raw_depth_m,
                             filtered_depth_m, rgb, static_prob, tick,
                             config)


def fuse_frame_sparse(smap: SurfelMap, curr_pose: torch.Tensor,
                      T_odometry: torch.Tensor, raw_depth_m: torch.Tensor,
                      filtered_depth_m: torch.Tensor, rgb: torch.Tensor,
                      static_prob: torch.Tensor, tick: torch.Tensor,
                      config: SFConfig) -> FuseResult:
    """Surfel-major association on the F-resolution z-buffer -> slot-space
    merge -> `post_factor` render of the merged map for the clean window
    test and the prediction splat -> lifecycle + watermark insert."""
    fus = config.fusion
    cfg1 = sparse.post_factor_config(config)
    if cfg1.fusion.index_factor == fus.index_factor:
        raise NotImplementedError(
            "post_factor == index_factor (materialize_from_winners) is not "
            "ported")
    last_pose = curr_pose
    curr_pose = curr_pose @ T_odometry
    weighting = velocity_weighting(curr_pose, last_pose, 1.0, config)
    local = project_surfels(smap, curr_pose, config)
    assoc = sparse.associate_sparse(smap, local, raw_depth_m,
                                    filtered_depth_m, rgb, static_prob,
                                    curr_pose, tick, weighting, config)
    merged_map = apply_updates(smap, assoc.updates, tick)
    tex1, _ = predict_indices(merged_map, curr_pose, tick, cfg1)
    kill_tex = window_kill_tex(tex1, tick, cfg1)
    killed = kill_mask_from_tex(kill_tex, tex1.idx, merged_map.capacity)
    smap_out = sparse.lifecycle_and_insert(merged_map, killed, assoc.new,
                                           tick, config)
    pred_has = (tex1.has & ~kill_tex & (tex1.conf >= fus.low_conf)
                & (tex1.z > fus.predict_z_min))
    pred = predict.splat_from_texels(tex1._replace(has=pred_has), cfg1)
    return FuseResult(smap=smap_out, curr_pose=curr_pose, pred=pred)
