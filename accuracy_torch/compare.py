"""Tabulate the port's accuracy record (this directory) beside the JAX
package's committed rows of the same names (the repository root), one
markdown row per configuration: ATE, RPE and IoU per seed and their seed
means, closures, the port's `fps` (host dispatch per frame, not a
speed; JAX's TPU figures are not shown), and the flags where the port's
mean ATE is over 1.5x JAX's or its mean IoU more than 0.05 under it.
False closures come from `check_closures` output: check_closures.txt
(the port's rows) and check_closures_jax.txt (the port's tool over the
JAX rows).  Reads JSON and text only.

  python accuracy_torch/compare.py
"""

import argparse
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ATE_RATIO = 1.5
IOU_DROP = 0.05


def configurations():
    """(label, [file names, one per seed])."""
    s3 = (0, 1, 2)
    out = [("walk F=4 100f (round-4 headline)",
            [f"ACC_r4_final_s{s}.json" for s in s3])]
    for mode in ("on", "off"):
        out.append((f"corridor 300f loop {mode}",
                    [f"ACC_r5_corridor_{mode}_s{s}.json" for s in s3]))
    for mode in ("on", "off"):
        out.append((f"corridor 1500f loop {mode}",
                    [f"ACC_r5_corridor1500_{mode}_s0.json"]))
    out.append(("corridor 300f λ 0.35",
                [f"SEG_r5_corr_lr0.35_s{s}.json" for s in s3]))
    for mode, name in (("routed", "auto"), ("full", "full")):
        out.append((f"VGA walk F=1 100f {mode}",
                    [f"ACC_r5_vga_{name}_s{s}.json" for s in s3]))
    for mode, name in (("routed", "auto"), ("full", "full")):
        out.append((f"VGA corridor F=1 200f {mode}",
                    [f"ACC_r5_vga_corridor_{name}.json"]))
    for lam in ("0.35", "0.9", "1.2", "1.6"):
        out.append((f"walk_var F=4 40f λ {lam}",
                    [f"SEG_r5_var_lr{lam}_s{s}.json" for s in s3]))
    return out


def load(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)[0]


def false_closures(path):
    """{file: false closures} from check_closures' summary lines."""
    out = {}
    if path:
        with open(path) as f:
            for line in f:
                if line.startswith("{"):
                    s = json.loads(line)
                    out[s["file"]] = s["false_closures_gt_0p5m"]
    return out


def fmt(vals, digits):
    return " / ".join("–" if v is None else f"{v:.{digits}f}" for v in vals)


def mean(vals):
    vals = [v for v in vals if v is not None]
    return float(np.mean(vals)) if vals else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--closures", default=os.path.join(HERE,
                                                       "check_closures.txt"))
    ap.add_argument("--jax-closures",
                    default=os.path.join(HERE, "check_closures_jax.txt"))
    args = ap.parse_args(argv)
    fc_port, fc_jax = (false_closures(p if os.path.exists(p) else None)
                       for p in (args.closures, args.jax_closures))
    print("| configuration | ATE m, port (seeds) | ATE m, JAX | RPE m, port "
          "| RPE m, JAX | IoU, port | IoU, JAX | closures (false), port | "
          "closures (false), JAX | fps, port (host dispatch) | flag |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for label, files in configurations():
        port = [load(os.path.join(HERE, f)) for f in files]
        ref = [load(os.path.join(ROOT, f)) for f in files]
        if any(r is None for r in port):
            print(f"| {label} | missing | | | | | | | | | |")
            continue
        col = lambda rows, k: [r[k] for r in rows]
        pa, ja = col(port, "ate_rmse_m"), col(ref, "ate_rmse_m")
        pi, ji = col(port, "seg_iou"), col(ref, "seg_iou")
        flags = []
        if mean(pa) > ATE_RATIO * mean(ja):
            flags.append(f"ATE {mean(pa) / mean(ja):.2f}x")
        if (mean(pi) is not None and mean(ji) is not None
                and mean(pi) < mean(ji) - IOU_DROP):
            flags.append(f"IoU {mean(pi) - mean(ji):+.3f}")

        def closures(rows, fc):
            if not any(r["loop"] for r in rows):
                return "–"
            return " / ".join(f"{r['closures']} ({fc.get(f, '?')})"
                              for r, f in zip(rows, files))
        print(f"| {label} | {fmt(pa, 4)} (mean {mean(pa):.4f}) | "
              f"{fmt(ja, 4)} (mean {mean(ja):.4f}) | "
              f"{fmt(col(port, 'rpe_rmse_m'), 4)} | "
              f"{fmt(col(ref, 'rpe_rmse_m'), 4)} | {fmt(pi, 3)} | "
              f"{fmt(ji, 3)} | {closures(port, fc_port)} | "
              f"{closures(ref, fc_jax)} | {fmt(col(port, 'fps'), 2)} | "
              f"{', '.join(flags) or 'ok'} |")


if __name__ == "__main__":
    main()
