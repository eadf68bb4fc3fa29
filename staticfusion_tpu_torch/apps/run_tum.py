"""TUM RGB-D evaluation run (the reference's StaticFusion-datasets.cpp,
headless): TUM PNG sequence + groundtruth anchor + trajectory export +
built-in ATE and RPE.  The port's copy of apps/run_tum.py:

  python -m staticfusion_tpu_torch.apps.run_tum DATASET_DIR [run_sequence flags]

This is run_sequence with TUM conventions pre-set: --depth-scale 5000 and,
unless --out is given, the trajectory goes to the first free
./odometry_results/experiment_NNN.txt.
"""

import os
import sys

from staticfusion_tpu_torch.apps import run_sequence


def _given(argv, flag: str) -> bool:
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def next_experiment(root: str = "odometry_results") -> str:
    """Reserve the first free root/experiment_NNN.txt (created empty, so
    two runs started at once take different numbers)."""
    os.makedirs(root, exist_ok=True)
    n = 0
    while True:
        path = os.path.join(root, f"experiment_{n:03d}.txt")
        try:
            with open(path, "x"):
                return path
        except FileExistsError:
            n += 1


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not _given(argv, "--depth-scale"):
        argv += ["--depth-scale", "5000"]
    if not _given(argv, "--out"):
        argv += ["--out", next_experiment()]
    run_sequence.main(argv)


if __name__ == "__main__":
    main()
