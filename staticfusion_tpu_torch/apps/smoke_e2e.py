"""End-to-end smoke: a synthetic 160x120 sequence of 8 frames through the
full pipeline; the port's copy of scripts/smoke_e2e.py, with `--device`
(the card by default; `--device cpu` runs the plain versions).

  python -m staticfusion_tpu_torch.apps.smoke_e2e [--dynamic] [--device cuda]

Prints per-frame surfel counts and odometry error, the final ATE and the
first relative poses against the ground-truth twist; with --dynamic a
sphere moves through the scene and each frame from the third prints the
mean static probability on and off it.
"""

import argparse
import time

import numpy as np
import torch

from staticfusion_tpu_torch.apps.run_camera import TWIST
from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                           SFConfig)
from staticfusion_tpu_torch.geometry.se3 import se3_exp
from staticfusion_tpu_torch.io import synthetic
from staticfusion_tpu_torch.pipeline.system import SlamSystem

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120),
                  fusion=FusionConfig(capacity=1 << 16))
N_FRAMES = 8
SPHERE = dict(center=np.array([0.3, 0.0, 1.8]), radius=0.35,
              velocity=np.array([-0.03, 0.0, 0.0]))


def main(argv=None) -> dict:
    """-> {"ate": ATE RMSE (m), "static_prob": [(frame, mean on the
    sphere, mean off it), ...] (with --dynamic, from frame 2)}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dynamic", action="store_true",
                    help="a sphere moves through the scene")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    args = ap.parse_args(argv)

    slam = SlamSystem(CONFIG, device=args.device)
    print("ctf_levels:", CONFIG.ctf_levels)
    sphere = synthetic.Sphere(**SPHERE) if args.dynamic else None
    frames, gt = synthetic.make_sequence(CONFIG, N_FRAMES, TWIST,
                                         sphere=sphere)
    dT_gt = se3_exp(torch.as_tensor(TWIST)).numpy()
    probs = []
    for i, (rgb, depth_mm, dyn) in enumerate(frames):
        t0 = time.time()
        out = slam.process(rgb, depth_mm, timestamp=float(i) / 30.0)
        if out is None:
            continue
        slam.block()
        T = out.T_odometry.cpu().numpy()
        print(f"frame {i}: {time.time() - t0:.1f}s "
              f"surfels={int(out.surfel_count)} dense={bool(out.dense)} "
              f"T_err={np.abs(T - dT_gt).max():.5f}")
        if args.dynamic and i >= 2:
            sp = out.static_prob.cpu().numpy()
            probs.append((i, float(sp[dyn].mean()), float(sp[~dyn].mean())))
            print(f"   static_prob: dyn={probs[-1][1]:.3f} "
                  f"stat={probs[-1][2]:.3f}")

    ate = slam.ate(np.arange(N_FRAMES) / 30.0, gt)
    print("ATE RMSE:", ate)
    print("gt dT translation:", dT_gt[:3, 3])
    for i in range(1, min(4, len(slam.poses))):
        rel = np.linalg.inv(slam.poses[i - 1]) @ slam.poses[i]
        print(f"rel {i}: t={rel[:3, 3]} (gt {dT_gt[:3, 3]})")
    return {"ate": float(ate), "static_prob": probs}


if __name__ == "__main__":
    main()
