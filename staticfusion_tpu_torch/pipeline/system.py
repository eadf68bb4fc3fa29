"""Host-side SLAM driver (port of the per-frame path of
staticfusion_tpu/pipeline/system.py).

The device holds all state; the host uploads the frame and keeps poses as
device tensors until they are read.  The map is re-tiered every
`resize_check_interval` frames, the only scheduled host read of the map
(besides the solver's per-level exit flag).  Loop closure, batch
processing and fixed tiers are not ported.
"""

from __future__ import annotations

from typing import List, Optional

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

    def process(self, rgb: np.ndarray, depth_mm: np.ndarray,
                timestamp: float) -> Optional[StepOutputs]:
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
        self.times.append(timestamp)
        self.poses.append(out.curr_pose)
        return out

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _materialize_poses(self):
        self.poses = [np.asarray(p.cpu() if isinstance(p, torch.Tensor)
                                 else p) for p in self.poses]

    def ate(self, gt_times: np.ndarray, gt_poses: np.ndarray,
            max_dt: float = 0.05) -> float:
        self._materialize_poses()
        return traj_io.ate_rmse(np.asarray(self.times),
                                np.stack(self.poses), gt_times, gt_poses,
                                max_dt=max_dt)
