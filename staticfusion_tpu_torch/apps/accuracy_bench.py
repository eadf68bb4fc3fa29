"""Accuracy benchmark on the adversarial synthetic suite; the port's copy
of scripts/accuracy_bench.py, with `--device` (the card by default;
`--device cpu` runs the plain versions) in place of `--cpu`.

Runs the full pipeline at QVGA over the adversarial profiles (walk_xyz:
30-45% articulated dynamic coverage; fast_rot: ~1.7 deg/frame yaw; static:
sensor noise only; walk_var, walk_loop, corridor_loop) through
`SlamSystem.process_batch` and reports ATE RMSE, RPE, segmentation IoU and
the closure record, at index_factor 1 and 4:

  python -m staticfusion_tpu_torch.apps.accuracy_bench [--frames 40]
      [--profiles walk_xyz,fast_rot,static] [--factors 1,4] [--seed 0]
      [--loop] [--lambda-reg L] [--route-factor R] [--res-factor 2]
      [--device cuda] [--json out.json]

The rows carry the JAX tool's keys.  The port has adaptive map tiers only,
so `fixed_tiers` is always false.  `fps` is 1 / the median of
`SlamSystem.frame_seconds[2:]`, each chunk's host dispatch time over its
frames with no synchronize at its end: a record of host dispatch, not a
speed.  Rendered sequences are cached as npz under $SF_ADV_CACHE
(default /tmp/sf_adv_cache), under the same names as the JAX generator's.
"""

import argparse
import json
import os

import numpy as np

from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                           LoopClosureConfig, SFConfig,
                                           SolverConfig)
from staticfusion_tpu_torch.io import adversarial as adv
from staticfusion_tpu_torch.io.trajectory import rpe_rmse
from staticfusion_tpu_torch.pipeline.state import entry_device
from staticfusion_tpu_torch.pipeline.system import SlamSystem


def cache_dir() -> str:
    """Where rendered adversarial sequences are cached (both packages'
    default, under identical file names)."""
    return os.environ.get("SF_ADV_CACHE", "/tmp/sf_adv_cache")


def make_row(slam: SlamSystem, profile: str, seed: int, frames, gt,
             probs) -> dict:
    """The JAX tool's row for a run of `frames` (rgb, depth_mm, dyn)
    through `slam` at 30 Hz; `probs` is process_batch's static-probability
    stack (frame i -> row i - 1, on any device) or None (then no IoU)."""
    config = slam.config
    n = len(frames)
    ious = []
    if probs is not None:
        probs = probs.cpu().numpy()
        for i in range(1, n):
            # IoU once the temporal ring has filled (rescue active) and
            # the walker is on screen.
            if i >= config.buffer_length and frames[i][2].sum() > 50:
                ious.append(adv.dynamic_iou(probs[i - 1], frames[i][2],
                                            frames[i][1]))
    times = np.arange(n) / 30.0
    ate = slam.ate(times, gt)    # brings the poses to the host
    rpe = rpe_rmse(np.asarray(slam.times), np.stack(slam.poses), times, gt)
    # Host dispatch seconds per frame; the median skips the bootstrap.
    fps = 1.0 / np.median(slam.frame_seconds[2:])
    loop = config.loop.enabled
    return {
        "profile": profile, "index_factor": config.fusion.index_factor,
        "frames": n,
        "post_factor": config.fusion.post_factor,
        "route_factor": config.fusion.route_factor,
        "lambda_reg": config.solver.lambda_reg,
        "seed": seed, "res_factor": 640 // config.camera.width,
        "loop": loop, "smooth_skip": config.loop.smooth_skip if loop else 0,
        "closures": len(slam.loop_closures),
        "closure_events": slam.loop_closures,
        "smoothings": len(slam.chain_smoothings),
        "db_halvings": slam.db_halvings,
        "ate_rmse_m": round(float(ate), 5),
        "rpe_rmse_m": round(float(rpe), 5),
        "seg_iou": round(float(np.mean(ious)), 4) if ious else None,
        "fps": round(float(fps), 2),
        "capacity": config.fusion.capacity,
        "capacity_events": slam.capacity_events,
        "fixed_tiers": False,
    }


def run_one(profile: str, factor: int, n_frames: int, res_factor: int = 2,
            seed: int = 0, post_factor=None, loop: bool = False,
            smooth_skip: int | None = None, lambda_reg: float | None = None,
            route_factor: int | None = None, capacity: int | None = None,
            device="cuda") -> dict:
    """One adversarial run through `process_batch` on `device`: the JAX
    tool's row (see make_row)."""
    # VGA full-resolution mapping needs the bigger tier (a VGA bootstrap
    # alone is ~307k surfels; 2^18 would hit the capacity wall at once).
    if capacity is None:
        capacity = 1 << (18 if res_factor >= 2 else 20)
    fkw = dict(capacity=capacity, index_factor=factor)
    if post_factor is not None:   # else the config default
        fkw["post_factor"] = post_factor
    if route_factor is not None:  # VGA routed-fusion A/B
        fkw["route_factor"] = route_factor
    skw = {} if lambda_reg is None else {"lambda_reg": lambda_reg}
    lkw = dict(enabled=loop)
    if smooth_skip is not None:
        lkw["smooth_skip"] = smooth_skip
    if os.environ.get("SF_LOOP_NO_DEFORM"):
        lkw["deform_map"] = False
    config = SFConfig(camera=CameraConfig(width=640 // res_factor,
                                          height=480 // res_factor),
                      solver=SolverConfig(**skw),
                      fusion=FusionConfig(**fkw),
                      loop=LoopClosureConfig(**lkw))
    slam = SlamSystem(config, device=device)
    frames, gt = adv.make_adversarial_sequence(config, n_frames, profile,
                                               seed=seed,
                                               cache_dir=cache_dir())
    probs = slam.process_batch([f[0] for f in frames],
                               [f[1] for f in frames],
                               [i / 30.0 for i in range(n_frames)],
                               collect_prob=True)
    slam.block()
    return make_row(slam, profile, seed, frames, gt, probs)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--profiles", default="walk_xyz,fast_rot,static")
    ap.add_argument("--factors", default="1,4")
    ap.add_argument("--post-factor", type=int, default=None)
    ap.add_argument("--loop", action="store_true",
                    help="enable keyframe loop closure + chain smoothing")
    ap.add_argument("--smooth-skip", type=int, default=None,
                    help="override LoopClosureConfig.smooth_skip (0 = off)")
    ap.add_argument("--res-factor", type=int, default=2)
    ap.add_argument("--lambda-reg", type=float, default=None,
                    help="override SolverConfig.lambda_reg (sweeps)")
    ap.add_argument("--route-factor", type=int, default=None,
                    help="override FusionConfig.route_factor (VGA A/B)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    return ap


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    entry_device(args.device)   # no card: raise before rendering anything
    rows = []
    for factor in [int(f) for f in args.factors.split(",")]:
        for profile in args.profiles.split(","):
            r = run_one(profile, factor, args.frames, args.res_factor,
                        args.seed, args.post_factor, loop=args.loop,
                        smooth_skip=args.smooth_skip,
                        lambda_reg=args.lambda_reg,
                        route_factor=args.route_factor, device=args.device)
            rows.append(r)
            print(json.dumps(r), flush=True)

    print("\n| profile | F | ATE RMSE (m) | RPE (m) | seg IoU | fps |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['profile']} | {r['index_factor']} | {r['ate_rmse_m']} "
              f"| {r['rpe_rmse_m']} | {r['seg_iou']} | {r['fps']} |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
