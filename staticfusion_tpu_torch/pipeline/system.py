"""The host side of the SLAM system (port of
staticfusion_tpu/pipeline/system.py without loop closure).

The device holds all state; the host uploads the frame and keeps poses and
per-frame scalars as device tensors until they are read.  The map is
re-tiered every `resize_check_interval` frames, the only scheduled host
read of the map (besides the solver's per-level exit flag).  Loop closure
raises, and the JAX package's TPU workarounds (fixed tiers, executable
cache clearing) are not carried over.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion.backend import check_supported
from staticfusion_tpu_torch.fusion.surfels import (SurfelMap, compact_map,
                                                   concat_maps, next_tier)
from staticfusion_tpu_torch.io import trajectory as traj_io
from staticfusion_tpu_torch.pipeline.state import entry_device
from staticfusion_tpu_torch.pipeline.step import (Frame, StepOutputs,
                                                  bootstrap_step, slam_step)


class FrameRecord(NamedTuple):
    """The per-frame scalars behind `SlamSystem.metrics` (device tensors
    until read).  Only the scalars are kept: a frame's StepOutputs would
    hold its images on the device for the whole run."""
    timestamp: float
    surfel_count: torch.Tensor
    dense: torch.Tensor
    ddt_sum: torch.Tensor


class SlamSystem:
    """Feed frames with `process(rgb, depth_mm, timestamp)`; read
    `poses`/`times` or call `ate()` against ground truth.  All tensors live
    on `device`: the card unless the caller asks for the CPU."""

    def __init__(self, config: SFConfig, device="cuda",
                 initial_pose: Optional[np.ndarray] = None,
                 resize_check_interval: int = 8):
        check_supported(config)
        if config.loop.enabled:
            raise NotImplementedError("loop closure is not ported")
        self.config = config
        self.device = entry_device(device)
        self.state = None
        self._pending = None  # first frame, buffered until bootstrap
        self.initial_pose = (np.eye(4, dtype=np.float32)
                             if initial_pose is None else initial_pose)
        self.times: List[float] = []
        self.poses: List = []  # device tensors until materialised
        self.ddt_sums: List = []  # per-frame sum(ddt), device scalars
        # A constant post-multiplied into every exported or evaluated pose
        # (rawlog runs set ROTATE_BY_Z so trajectories land in the raw TUM
        # ground-truth frame); applied once, when the poses are read.
        self.pose_postmultiply: Optional[np.ndarray] = None
        self._pending_metrics: List[FrameRecord] = []
        # Host seconds per frame (no sync at its end: device work still
        # queued may fall into the next frame's time).
        self.frame_seconds: List[float] = []
        # Map tiering: every `resize_check_interval` frames read the live
        # count and repack into the smallest tier with headroom, so
        # per-surfel passes scale with the live map.  The repack renumbers
        # surfels and the z-buffer ties depend on the numbering, so this
        # schedule is part of the results.
        self.resize_check_interval = max(1, resize_check_interval)
        self._frames_since_resize_check = 0
        # Stale surfels (never rendered again) move to the archive in
        # batches worth a repack.
        self.archive_min_batch = 4096
        self.archive: SurfelMap | None = None
        self.capacity_events: List[dict] = []

    def _maybe_resize_map(self):
        self._frames_since_resize_check += 1
        if self._frames_since_resize_check < self.resize_check_interval:
            return
        self._frames_since_resize_check = 0
        smap = self.state.smap
        fus = self.config.fusion
        tickf = self.state.tick.to(torch.float32)
        stale = smap.valid & ((tickf - smap.last_time) > fus.time_delta)
        n_stale = int(torch.sum(stale.to(torch.int32)))
        count = int(smap.count()) - n_stale
        if n_stale >= self.archive_min_batch:
            extracted = compact_map(smap, next_tier(n_stale), keep_mask=stale)
            self.archive = (extracted if self.archive is None else
                            compact_map(concat_maps(self.archive, extracted),
                                        next_tier(int(self.archive.count())
                                                  + n_stale)))
            keep_fresh = ~stale
        else:
            count += n_stale  # a small stale residue stays in the live map
            keep_fresh = None
        cam = self.config.camera
        per_frame = (cam.height * cam.width + 3) // 4  # checkerboard bound
        headroom = count // 4 + self.resize_check_interval * per_frame // 4
        want = max(4096, next_tier(count + headroom))
        tier = min(fus.capacity, want)
        if want > fus.capacity and not self.capacity_events:
            # From here on, inserts drop whenever no free slot is left
            # after a repack; updates to existing surfels continue.
            self.capacity_events.append({"tick": int(self.state.tick),
                                         "live": count,
                                         "capacity": fus.capacity})
            print(f"[map] surfel map near capacity ({count} live / "
                  f"{fus.capacity} slots): new-surfel inserts will drop when "
                  "no free slots remain; raise FusionConfig.capacity for "
                  "larger scenes", flush=True)
        # Repack (same tier) also when the append high-water mark nears the
        # tier, to reclaim slots freed by kills.
        watermark_full = (int(smap.used)
                          + self.resize_check_interval * per_frame
                          > smap.capacity)
        if tier != smap.capacity or watermark_full or keep_fresh is not None:
            self.state = self.state._replace(
                smap=compact_map(smap, tier, keep_mask=keep_fresh))

    def full_map(self) -> SurfelMap:
        """Active + archived surfels as one compact map."""
        smap = self.state.smap
        if self.archive is None:
            return smap
        total = int(smap.count()) + int(self.archive.count())
        return compact_map(concat_maps(smap, self.archive),
                           next_tier(max(1, total)))

    def total_surfels(self) -> int:
        n = int(self.state.smap.count())
        if self.archive is not None:
            n += int(self.archive.count())
        return n

    def _to_frame(self, rgb, depth_mm) -> Frame:
        return Frame(
            rgb=torch.as_tensor(np.asarray(rgb, np.float32),
                                device=self.device),
            depth_mm=torch.as_tensor(np.asarray(depth_mm, np.float32),
                                     device=self.device))

    def _record(self, timestamp: float, out: StepOutputs) -> None:
        self.times.append(timestamp)
        self.poses.append(out.curr_pose)
        self.ddt_sums.append(out.ddt_sum)
        self._pending_metrics.append(FrameRecord(
            timestamp, out.surfel_count, out.dense, out.ddt_sum))

    def process(self, rgb: np.ndarray, depth_mm: np.ndarray,
                timestamp: float) -> Optional[StepOutputs]:
        t0 = time.perf_counter()
        frame = self._to_frame(rgb, depth_mm)
        if self.state is None and self._pending is None:
            self._pending = frame
            return None
        if self.state is None:
            frame0, self._pending = self._pending, None
            self.state, out = bootstrap_step(
                frame0, frame,
                torch.as_tensor(np.asarray(self.initial_pose, np.float32),
                                device=self.device), self.config)
        else:
            self.state, out = slam_step(self.state, frame, self.config)
        self._maybe_resize_map()
        self._record(timestamp, out)
        self.frame_seconds.append(time.perf_counter() - t0)
        return out

    def process_batch(self, rgbs, depth_mms, timestamps,
                      collect_prob: bool = False) -> Optional[torch.Tensor]:
        """Bootstrap through `process`, then the rest in chunks of
        `resize_check_interval` frames with the map's tier check after
        every chunk, on the schedule of the JAX package's batch path (its
        chunks are one `lax.scan` each; here a loop over `slam_step`).
        The schedule is part of the results: a repack renumbers surfels
        and z-buffer ties depend on the numbering.

        Returns the stacked static-probability images of the processed
        frames (n - 1, H, W) when `collect_prob`, else None."""
        n = len(timestamps)
        probs = [] if collect_prob else None
        i = 0
        while i < n and self.state is None:
            out = self.process(rgbs[i], depth_mms[i], timestamps[i])
            if collect_prob and out is not None:
                probs.append(out.static_prob[None])
            i += 1
        chunk = self.resize_check_interval
        while i < n:
            k = min(chunk, n - i)
            t0 = time.perf_counter()
            for j in range(i, i + k):
                self.state, out = slam_step(
                    self.state, self._to_frame(rgbs[j], depth_mms[j]),
                    self.config)
                self._record(timestamps[j], out)
                if collect_prob:
                    probs.append(out.static_prob[None])
            self.frame_seconds.extend([(time.perf_counter() - t0) / k] * k)
            i += k
            self._frames_since_resize_check = self.resize_check_interval
            self._maybe_resize_map()
        return torch.cat(probs) if probs else None

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def metrics(self) -> List[dict]:
        return [{"timestamp": r.timestamp, "surfels": int(r.surfel_count),
                 "dense": bool(r.dense), "ddt_sum": float(r.ddt_sum)}
                for r in self._pending_metrics]

    def _materialize_poses(self):
        self.poses = [np.asarray(p.cpu() if isinstance(p, torch.Tensor)
                                 else p) for p in self.poses]
        if self.pose_postmultiply is not None:
            M = np.asarray(self.pose_postmultiply, np.float32)
            self.poses = [p @ M for p in self.poses]
            self.pose_postmultiply = None  # applied exactly once

    def write_trajectory(self, path: str) -> None:
        """TUM-format export.  Frames whose depth-residual sum is exactly
        zero are skipped, as the reference's writeTrajectoryFile does
        (Utils/Datasets.cpp:252-266): a zero ddt image means the solver saw
        a repeated or empty depth frame."""
        self._materialize_poses()
        keep = [i for i, d in enumerate(self.ddt_sums) if float(d) != 0.0]
        traj_io.write_tum_trajectory(path, [self.times[i] for i in keep],
                                     [self.poses[i] for i in keep])

    def ate(self, gt_times: np.ndarray, gt_poses: np.ndarray,
            max_dt: float = 0.05) -> float:
        self._materialize_poses()
        return traj_io.ate_rmse(np.asarray(self.times),
                                np.stack(self.poses), gt_times, gt_poses,
                                max_dt=max_dt)

    def rpe(self, gt_times: np.ndarray, gt_poses: np.ndarray,
            delta: int = 1, max_dt: float = 0.05) -> float:
        """Translational drift RMSE over `delta`-frame intervals."""
        self._materialize_poses()
        return traj_io.rpe_rmse(np.asarray(self.times),
                                np.stack(self.poses), gt_times, gt_poses,
                                delta=delta, max_dt=max_dt)
