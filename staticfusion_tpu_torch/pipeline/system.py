"""The host side of the SLAM system (port of
staticfusion_tpu/pipeline/system.py).

The device holds all state; the host uploads the frame and keeps poses and
per-frame scalars as device tensors until they are read.  The map is
re-tiered every `resize_check_interval` frames, the only scheduled host
read of the map (besides the solver's per-level exit flag).  With loop
closure on (`config.loop`), every keyframe tick reads the query distance
and, for a candidate, the verification results on the host.  The JAX
package's TPU workarounds (fixed tiers, executable cache clearing) and its
progress printing are not carried over.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion.surfels import (SurfelMap, compact_map,
                                                   concat_maps, next_tier)
from staticfusion_tpu_torch.geometry.se3 import se3_inverse
from staticfusion_tpu_torch.io import trajectory as traj_io
from staticfusion_tpu_torch.pipeline import keyframes
from staticfusion_tpu_torch.pipeline.state import entry_device
from staticfusion_tpu_torch.pipeline.step import (Frame, StepOutputs,
                                                  _intensity, bootstrap_step,
                                                  slam_step)


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
        # Loop closure: the keyframe DB lives on the device.  The keyframe
        # stride starts at kf_interval and doubles whenever the DB nears
        # capacity (keyframes.halve_db), so the fixed DB spans any run.
        self._kf_db = (keyframes.empty_db(config.loop.capacity, config.rows,
                                          config.cols, device=self.device)
                       if config.loop.enabled else None)
        self._kf_stride = max(1, config.loop.kf_interval)
        self.db_halvings: List[dict] = []
        self.loop_closures: List[dict] = []
        self.chain_smoothings: List[dict] = []  # skip-constraint corrections

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
        if self._kf_db is not None:
            out = self._maybe_close_loop(frame, out)
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
        and z-buffer ties depend on the numbering.  With loop closure on, a
        chunk ends before the next keyframe tick, and the tick frame goes
        through `process` (the closure decision is the host's).

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
            if self._kf_db is not None:
                until_tick = (-len(self.times)) % self._kf_stride
                if until_tick == 0:
                    out = self.process(rgbs[i], depth_mms[i], timestamps[i])
                    if collect_prob:
                        probs.append(out.static_prob[None])
                    i += 1
                    continue
                k = min(k, until_tick)
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

    def _maybe_close_loop(self, frame: Frame,
                          out: StepOutputs) -> StepOutputs:
        """Every keyframe tick: fingerprint, query the DB and, on a
        candidate, verify it with two frame-to-frame solves and correct the
        pose graph; then add the frame as a keyframe.  The query distance
        and a candidate's verification results are the only host reads."""
        lc = self.config.loop
        n = len(self.times)  # frames recorded before this one
        if n % self._kf_stride != 0:
            return out
        db = self._kf_db
        if int(db.count) >= db.emb.shape[0] - 1:
            # Near capacity: halve the density and double the stride, so
            # the DB spans the rest of the run and the chain node that
            # _apply_graph_correction appends always has a free slot.
            db = keyframes.halve_db(db)
            self._kf_stride *= 2
            self.db_halvings.append({"frame": n, "stride": self._kf_stride,
                                     "keyframes": int(db.count)})
            print(f"[loop] keyframe DB at capacity: halved to "
                  f"{int(db.count)} keyframes, stride -> "
                  f"{self._kf_stride} frames", flush=True)
        inten = _intensity(frame.rgb)
        depth = frame.depth_mm / 1000.0
        best, dist = keyframes.query(db, keyframes.fingerprint(inten, depth),
                                     n, lc.min_gap)
        pose = out.curr_pose
        closed = False
        if float(dist) < lc.max_fp_dist:
            k = int(best)
            # Two verification solves, the better-verified kept: identity
            # is in the basin of a genuine revisit, the chain-predicted
            # relative pose T0 in that of a drifted but overlapping pair.
            T0 = se3_inverse(db.poses[k]) @ pose
            T_a, r_a = keyframes.relative_pose(
                db.intensity[k], db.depth[k], inten, depth, self.config)
            T_b, r_b = keyframes.relative_pose(
                db.intensity[k], db.depth[k], inten, depth, self.config,
                T_init=T0)
            T, resid = (T_a, r_a) if float(r_a) <= float(r_b) else (T_b, r_b)
            resid = float(resid)
            t0, t, t_a, t_b = (np.asarray(m.cpu())[:3, 3]
                               for m in (T0, T, T_a, T_b))
            # Drift budget: the correction a closure implies may grow with
            # the frames since its keyframe.  Dual-init agreement is asked
            # only of large corrections: a genuine revisit solves to the
            # same transform from both inits, a z-aliased corridor pair to
            # two period solutions.
            gap_frames = max(1, n - int(db.frame_idx[k]))
            correction_m = float(np.linalg.norm(t0 - t))
            budget_m = lc.max_drift_rate * gap_frames + 0.05
            agree_m = float(np.linalg.norm(t_a - t_b))
            plausible = (correction_m <= budget_m
                         and (correction_m <= 0.3 or agree_m < 0.15))
            if resid < lc.max_residual and plausible:
                pose_before = np.asarray(pose.cpu())
                pose, db = self._apply_graph_correction(
                    db, pose, n, k, T, lc.loop_weight)
                out = out._replace(curr_pose=pose)
                closed = True
                self.loop_closures.append({
                    "frame": n, "keyframe": int(db.frame_idx[k]),
                    "fp_dist": float(dist), "residual": resid,
                    # The measured constraint (current -> keyframe), so a
                    # closure can be checked against ground truth.
                    "T_rel": np.asarray(T.cpu()).tolist(),
                    "correction_m": correction_m, "budget_m": budget_m,
                    "gap_m": float(np.linalg.norm(
                        np.asarray(pose.cpu())[:3, 3] - pose_before[:3, 3]))})
        if (not closed and lc.smooth_skip > 0
                and int(db.count) > lc.smooth_skip):
            # Chain smoothing: measure a skip constraint (keyframe
            # count - smooth_skip -> this frame) with the same verified
            # solve and optimise the chain against it.
            k = int(db.count) - lc.smooth_skip
            T, resid = keyframes.relative_pose(
                db.intensity[k], db.depth[k], inten, depth, self.config,
                T_init=se3_inverse(db.poses[k]) @ pose)
            if float(resid) < lc.max_residual:
                pose, db = self._apply_graph_correction(
                    db, pose, n, k, T, lc.smooth_weight)
                out = out._replace(curr_pose=pose)
                self.chain_smoothings.append({
                    "frame": n, "keyframe": int(db.frame_idx[k]),
                    "residual": float(resid)})
        self._kf_db = keyframes.add_keyframe(db, inten, depth, pose, n)
        return out

    def _apply_graph_correction(self, db, pose, n, k, T, weight):
        """Optimise the keyframe chain against one measured constraint
        (keyframe k -> this frame, appended as node `count`) and apply the
        solution to the current pose, the keyframe DB, the recorded
        trajectory, the live map and the archive."""
        lc = self.config.loop
        cur_node = int(db.count)
        chain = db.poses.clone()
        chain[cur_node] = pose
        opt = keyframes.close_loop(chain, cur_node + 1, k, cur_node, T,
                                   weight, lc.gn_iters)
        pose = opt[cur_node]
        db = db._replace(poses=opt)
        self.state = self.state._replace(curr_pose=pose)
        # Every recorded frame rides the correction of the last keyframe at
        # or before it (the rule of deform_map), so the trajectory loses
        # its drift too, not only the current pose.
        chain_np = np.asarray(chain[:cur_node + 1].cpu())
        opt_np = np.asarray(opt[:cur_node + 1].cpu())
        delta = opt_np @ np.linalg.inv(chain_np)
        keys = np.asarray(db.frame_idx[:cur_node + 1].cpu()).copy()
        keys[cur_node] = n
        self._materialize_raw_poses()
        seg = np.clip(np.searchsorted(keys, np.arange(len(self.poses)),
                                      side="right") - 1, 0, cur_node)
        self.poses = [np.asarray(delta[seg[j]] @ p, np.float32)
                      for j, p in enumerate(self.poses)]
        if lc.deform_map:
            # The surfels move with their birth-interval keyframes; the
            # archive's too (its surfels are part of the corrected world).
            fidx = db.frame_idx.clone()
            fidx[cur_node] = n
            self.state = self.state._replace(smap=keyframes.deform_map(
                self.state.smap, fidx, chain, opt, cur_node + 1))
            if self.archive is not None:
                self.archive = keyframes.deform_map(
                    self.archive, fidx, chain, opt, cur_node + 1)
        return pose, db

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def metrics(self) -> List[dict]:
        return [{"timestamp": r.timestamp, "surfels": int(r.surfel_count),
                 "dense": bool(r.dense), "ddt_sum": float(r.ddt_sum)}
                for r in self._pending_metrics]

    def _materialize_raw_poses(self):
        """The recorded poses as host arrays, without pose_postmultiply."""
        self.poses = [np.asarray(p.cpu() if isinstance(p, torch.Tensor)
                                 else p) for p in self.poses]

    def _materialize_poses(self):
        self._materialize_raw_poses()
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
