"""The benchmark's command:

    python3 sfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA card.  It
prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and with
`--trace 1` `breakdown`), and last the numbers the check compared beside
their limits (`checks`), which also end standard error.  Without a card,
or with fewer cards than the cell asks for, it exits with 2 and prints no
result; if JAX or the JAX package is loaded once the window has closed,
with 3.  Build and kernel caches stay inside the checkout (`build/`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its kernel library into `build/torch_kernels/` of
    the checkout by itself."""
    cache = ROOT / "build" / "sfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from sfbench import harness
    try:
        spec = harness.load_cell(args.workload)
    except (OSError, ValueError, KeyError, StopIteration,
            harness.CellError) as e:
        print(f"sfbench: cannot load {args.workload!r}: {e!r}",
              file=sys.stderr)
        return 2
    import torch
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"sfbench: the cell needs {need} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"sfbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
