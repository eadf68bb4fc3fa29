"""Loop-closure threshold calibration; the port's copy of
scripts/calibrate_loop.py, with `--device` (the card by default;
`--device cpu` runs the plain versions) in place of `--cpu`.

Builds two populations of keyframe pairs from synthetic worlds:
  * POSITIVE: genuine revisits (same viewpoint up to small offsets),
  * NEGATIVE: non-revisits (views >= min_gap apart on a yaw sweep, plus
    an aliased same-texture/different-geometry pair, last),
and prints the fingerprint-distance and verification-residual
distributions with the implied operating point for
LoopClosureConfig.max_fp_dist / max_residual.

  python -m staticfusion_tpu_torch.apps.calibrate_loop [--device cuda]
"""

import argparse

import numpy as np
import torch

from staticfusion_tpu_torch.config import CameraConfig, SFConfig
from staticfusion_tpu_torch.io import synthetic
from staticfusion_tpu_torch.pipeline import keyframes as kf
from staticfusion_tpu_torch.pipeline.state import entry_device
from staticfusion_tpu_torch.pipeline.step import _intensity

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120))
# Positives: revisits with residual motion of 0..3 small steps.
POS_TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002],
                     np.float32)
POS_PAIRS = [(0, k) for k in (1, 2, 3)] + [(4, 6), (5, 8)]
# Negatives: a yaw sweep, pairs >= 8 frames (~0.8 rad) apart.
NEG_TWIST = np.array([0, 0, 0, 0, 0.1, 0], np.float32)
NEG_PAIRS = [(0, 9), (0, 12), (2, 11), (4, 13)]


def _pair(ii, di, ij, dj):
    fp = float(torch.mean((kf.fingerprint(ii, di)
                           - kf.fingerprint(ij, dj)) ** 2))
    _, resid = kf.relative_pose(ii, di, ij, dj, CONFIG)
    return fp, float(resid)


def populations(device="cuda"):
    """(pos, neg): [(fp_dist, verification residual), ...] of the positive
    and the negative pairs on `device`; the aliased pair is neg's last."""
    device = entry_device(device)

    def prep(rgb, depth_mm):
        return (_intensity(torch.as_tensor(rgb, device=device)),
                torch.as_tensor(depth_mm, dtype=torch.float32,
                                device=device) / 1000.0)

    def stats(frames, pairs):
        return [_pair(*prep(*frames[i][:2]), *prep(*frames[j][:2]))
                for i, j in pairs]

    frames, _ = synthetic.make_sequence(CONFIG, 10, POS_TWIST)
    pos = stats(frames, POS_PAIRS)
    sweep, _ = synthetic.make_sequence(CONFIG, 14, NEG_TWIST)
    neg = stats(sweep, NEG_PAIRS)

    # Aliased negative: identical texture, corrugated vs smooth geometry.
    rows, cols = CONFIG.rows, CONFIG.cols
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    inten = t(0.5 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 7.0))
    da = 1.5 + 1.0 * (xx / cols)
    db = da + 0.35 * np.sin(xx / 2.1) * np.sin(yy / 1.7)
    neg.append(_pair(inten, t(da), inten, t(db)))
    return pos, neg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (default: the card)")
    args = ap.parse_args(argv)
    pos, neg = populations(args.device)

    print("pair           fp_dist     verif_residual")
    for tag, rows_ in (("POS", pos), ("NEG", neg)):
        for fp, r in rows_:
            print(f"{tag}   {fp:12.3e} {r:12.4f}")
    pos_fp = max(p for p, _ in pos)
    neg_fp = min(p for p, _ in neg[:-1])   # sweep negatives (last = aliased)
    pos_r = max(r for _, r in pos)
    r_alias = neg[-1][1]
    print(f"\nmax positive fp_dist        : {pos_fp:.3e}")
    print(f"min non-aliased neg fp_dist : {neg_fp:.3e}")
    print(f"aliased-pair fp_dist        : {neg[-1][0]:.3e} (passes the fp "
          "gate, by construction)")
    print(f"max positive residual       : {pos_r:.4f}")
    print(f"aliased-pair residual       : {r_alias:.4f}")
    print(f"-> max_fp_dist in ({pos_fp:.1e}, {neg_fp:.1e}); default 5e-3 "
          "sits just above the worst genuine revisit.")
    print(f"-> max_residual in ({pos_r:.1e}, {r_alias:.1e}); default 0.03 "
          "keeps margin over genuine matches while rejecting aliased "
          "geometry here.  In self-similar corridors the genuine and "
          "aliased residual populations overlap, so the residual gate "
          "alone is insufficient: the drift-budget and dual-init "
          "agreement gates (LoopClosureConfig.max_drift_rate, "
          "pipeline/system.py) are the discriminating defenses there; "
          "see ACCURACY.md round 5.")
    return pos, neg


if __name__ == "__main__":
    main()
