"""The readings that the limits of `correct` are set from: for one cell,
every variant's numbers of each checked frame of the program and of the
control (the reference in TF32 put in the program's place), and the
tier checks' numbers, on each of a list of seeds, in one process.

    python3 sfbench/calibrate.py --workload qvga_f4.walk --seconds 12 \\
        --seeds 101 102 103 ... > readings.jsonl

Prints one JSON line a seed (PERF.md reads them into the limits).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from sfbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "device": torch.cuda.get_device_name(0),
            "attempted": r["attempted"], "correct": r["correct"],
            "checks": r["checks"], "fps": r["metrics"]["fps"]["value"],
            "rows": r["rows"], "tier": r["tier"],
            "control_rows": r["control_rows"],
            "control": r["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
