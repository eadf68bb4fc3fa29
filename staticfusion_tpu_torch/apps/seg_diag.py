"""Segmentation diagnostic: precision/recall/IoU of the dynamic mask per
frame on the adversarial walk suite; the port's copy of
scripts/seg_diag.py, with `--device` (the card by default; `--device cpu`
runs the plain versions) in place of `--cpu`.

  python -m staticfusion_tpu_torch.apps.seg_diag [--frames 40] [--seed 0]
      [--factor 4] [--kb 1.5] [--kz 1.5] [--lambda-reg 0.35]
      [--lambda-prior L] [--rescue 0.017] [--threshold 0.5]
      [--json out.json] [--save-probs probs.npz] [--device cuda]
"""

import argparse
import json

import numpy as np

from staticfusion_tpu_torch.apps.accuracy_bench import cache_dir
from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                           SFConfig, SolverConfig)
from staticfusion_tpu_torch.io import adversarial as adv
from staticfusion_tpu_torch.pipeline.state import entry_device
from staticfusion_tpu_torch.pipeline.system import SlamSystem


def frame_stats(static_prob: np.ndarray, dyn: np.ndarray,
                depth_mm: np.ndarray, threshold: float = 0.5) -> dict:
    """IoU, precision and recall of the predicted dynamic region
    (static_prob < threshold) against the ground-truth mask, over pixels
    with valid depth, and the ground truth's pixel count."""
    valid = depth_mm > 0
    pred = (static_prob < threshold) & valid
    gtm = dyn & valid
    tp = float((pred & gtm).sum())
    fp = float((pred & ~gtm).sum())
    fn = float((~pred & gtm).sum())
    return {"iou": tp / max(tp + fp + fn, 1.0),
            "precision": tp / max(tp + fp, 1.0),
            "recall": tp / max(tp + fn, 1.0),
            "gt_px": int(gtm.sum())}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--kb", type=float, default=None)
    ap.add_argument("--kz", type=float, default=None)
    ap.add_argument("--lambda-reg", type=float, default=None)
    ap.add_argument("--lambda-prior", type=float, default=None)
    ap.add_argument("--rescue", type=float, default=None)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--json", default=None)
    ap.add_argument("--save-probs", default=None,
                    help="npz path for per-frame static_prob + gt masks "
                         "(offline error-geography analysis)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = entry_device(args.device)
    skw = {}
    for key in ("kb", "kz", "lambda_reg", "lambda_prior"):
        if getattr(args, key) is not None:
            skw[key] = getattr(args, key)
    ckw = {}
    if args.rescue is not None:
        ckw["rescue_residual_threshold"] = args.rescue
    config = SFConfig(camera=CameraConfig(width=320, height=240),
                      solver=SolverConfig(**skw),
                      fusion=FusionConfig(capacity=1 << 18,
                                          index_factor=args.factor),
                      **ckw)
    frames, gt = adv.make_adversarial_sequence(
        config, args.frames, "walk_xyz", seed=args.seed,
        cache_dir=cache_dir())
    slam = SlamSystem(config, device=device)
    depths = [f[1] for f in frames]
    dyns = [f[2] for f in frames]
    probs = slam.process_batch([f[0] for f in frames], depths,
                               [i / 30.0 for i in range(args.frames)],
                               collect_prob=True)
    slam.block()
    probs = probs.cpu().numpy()

    rows = []
    for i in range(1, args.frames):
        if i < config.buffer_length or dyns[i].sum() <= 50:
            continue
        rows.append({"frame": i, **frame_stats(probs[i - 1], dyns[i],
                                               depths[i], args.threshold)})

    ate = slam.ate(np.arange(args.frames) / 30.0, gt)
    mean = lambda key: round(float(np.mean([r[key] for r in rows])), 4)
    agg = {
        "kb": config.solver.kb, "kz": config.solver.kz,
        "lambda_reg": config.solver.lambda_reg,
        "lambda_prior": config.solver.lambda_prior,
        "rescue": config.rescue_residual_threshold,
        "seed": args.seed, "frames": args.frames,
        "ate_rmse_m": round(float(ate), 5),
        "iou": mean("iou"), "precision": mean("precision"),
        "recall": mean("recall"),
    }
    print(json.dumps(agg))
    if args.save_probs:
        np.savez_compressed(args.save_probs, probs=probs,
                            dyn=np.stack(dyns), depth=np.stack(depths))
    result = {"aggregate": agg, "frames": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
