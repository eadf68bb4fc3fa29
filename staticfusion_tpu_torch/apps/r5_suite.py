"""Round-5 evidence suite; the port's copy of scripts/r5_suite.py, with
the same groups, file names and runs, and `--device` (the card by
default).  Each group is a list of (JSON file, accuracy_bench.run_one
keyword arguments); every run writes its row as a one-row JSON list into
the working directory:

  python -m staticfusion_tpu_torch.apps.r5_suite corridor  # on/off x 3 seeds (+1500 frames)
  python -m staticfusion_tpu_torch.apps.r5_suite corrlam   # corridor at lambda 0.35
  python -m staticfusion_tpu_torch.apps.r5_suite vga       # VGA routed vs full, walk + corridor
  python -m staticfusion_tpu_torch.apps.r5_suite walkvar   # lambda sweep on the walk_var world

The corridor group skips files that exist, as the JAX suite's does; the
others rewrite theirs.  The JAX suite's `fixed_tiers=False` (walkvar) has
no counterpart: the port has adaptive tiers only.
"""

import argparse
import json
import os

from staticfusion_tpu_torch.apps.accuracy_bench import run_one
from staticfusion_tpu_torch.pipeline.state import entry_device

CORRIDOR = dict(profile="corridor_loop", factor=4, capacity=1 << 18)


def corridor() -> list:
    plan = []
    for s in (0, 1, 2):
        plan.append((f"ACC_r5_corridor_on_s{s}.json",
                     dict(CORRIDOR, n_frames=300, seed=s, loop=True)))
        plan.append((f"ACC_r5_corridor_off_s{s}.json",
                     dict(CORRIDOR, n_frames=300, seed=s, loop=False)))
    plan.append(("ACC_r5_corridor1500_on_s0.json",
                 dict(CORRIDOR, n_frames=1500, seed=0, loop=True)))
    plan.append(("ACC_r5_corridor1500_off_s0.json",
                 dict(CORRIDOR, n_frames=1500, seed=0, loop=False)))
    return plan


def corrlam() -> list:
    return [(f"SEG_r5_corr_lr0.35_s{s}.json",
             dict(CORRIDOR, n_frames=300, seed=s, lambda_reg=0.35))
            for s in (0, 1, 2)]


def vga() -> list:
    walk = dict(profile="walk_xyz", factor=1, n_frames=100, res_factor=1)
    corr = dict(profile="corridor_loop", factor=1, n_frames=200,
                res_factor=1, seed=0)
    return ([(f"ACC_r5_vga_auto_s{s}.json", dict(walk, seed=s))
             for s in (0, 1, 2)]
            + [(f"ACC_r5_vga_full_s{s}.json",
                dict(walk, seed=s, route_factor=1)) for s in (0, 1, 2)]
            + [("ACC_r5_vga_corridor_auto.json", corr),
               ("ACC_r5_vga_corridor_full.json",
                dict(corr, route_factor=1))])


def walkvar() -> list:
    return [(f"SEG_r5_var_lr{lam}_s{s}.json",
             dict(profile="walk_var", factor=4, n_frames=40, seed=s,
                  lambda_reg=lam))
            for lam in (0.35, 0.9, 1.2, 1.6) for s in (0, 1, 2)]


GROUPS = {"corridor": corridor, "corrlam": corrlam, "vga": vga,
          "walkvar": walkvar}


def emit(path: str, row: dict) -> None:
    print(json.dumps(row), flush=True)
    with open(path, "w") as f:
        json.dump([row], f, indent=2)


def run_group(group: str, device="cuda") -> None:
    for path, kwargs in GROUPS[group]():
        if group == "corridor" and os.path.exists(path):
            continue
        emit(path, run_one(**kwargs, device=device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("group", choices=sorted(GROUPS))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs (default: the card)")
    args = ap.parse_args(argv)
    entry_device(args.device)   # no card: raise before rendering anything
    run_group(args.group, args.device)
    print(f"GROUP {args.group} DONE", flush=True)


if __name__ == "__main__":
    main()
