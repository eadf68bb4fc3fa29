"""Validate the accepted loop closures of an accuracy_bench JSON against the
ground truth; the port's copy of scripts/check_closures.py.

For each closure event (which records the measured constraint T_rel =
kf_T_cur), compare against the true relative pose from the cached
sequence's ground-truth trajectory.  A genuine closure's translation error
is centimetres; a z-aliased false closure is off by metres.  Prints one
line per closure plus a summary per row.  Host only (numpy); the
sequence comes from $SF_ADV_CACHE when it was rendered there.

  python -m staticfusion_tpu_torch.apps.check_closures ACC_r5_corridor_on_s0.json [...]
"""

import argparse
import json
import os

import numpy as np

from staticfusion_tpu_torch.apps.accuracy_bench import cache_dir
from staticfusion_tpu_torch.config import CameraConfig, SFConfig
from staticfusion_tpu_torch.io import adversarial as adv

FALSE_CLOSURE_M = 0.5   # translation error that marks a false closure


def t_errors(closures, gt) -> list:
    """Translation error (m) of each closure's T_rel against the
    ground-truth relative pose from its keyframe to its frame."""
    return [float(np.linalg.norm(
        np.asarray(c["T_rel"])[:3, 3]
        - (np.linalg.inv(gt[c["keyframe"]]) @ gt[c["frame"]])[:3, 3]))
        for c in closures]


def check(path: str) -> list:
    """One summary per row of the JSON at `path`: closures, largest and
    median T error, false closures (T error > 0.5 m)."""
    with open(path) as f:
        rows = json.load(f)
    name = os.path.basename(path)
    out = []
    for r in rows:
        rf = r.get("res_factor", 2)
        cfg = SFConfig(camera=CameraConfig(width=640 // rf,
                                           height=480 // rf))
        _, gt = adv.make_adversarial_sequence(
            cfg, r["frames"], r["profile"], seed=r.get("seed", 0),
            cache_dir=cache_dir())
        events = r.get("closure_events", [])
        errs = t_errors(events, gt)
        for c, err in zip(events, errs):
            print(f"{name}: kf {c['keyframe']} -> frame {c['frame']}: "
                  f"|T - T_gt| = {err * 100:.1f} cm "
                  f"(residual {c['residual']:.4f})")
        summary = {
            "file": name,
            "closures": len(errs),
            "max_T_err_m": round(max(errs), 4) if errs else None,
            "median_T_err_m": round(float(np.median(errs)), 4) if errs
            else None,
            "false_closures_gt_0p5m": int(sum(e > FALSE_CLOSURE_M
                                              for e in errs)),
        }
        print(json.dumps(summary))
        out.append(summary)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="accuracy_bench JSON files")
    args = ap.parse_args(argv)
    return [s for p in args.paths for s in check(p)]


if __name__ == "__main__":
    main()
