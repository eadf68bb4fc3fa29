"""Multi-process SLAM launcher / worker (the port's copy of
scripts/run_multihost.py).  One process is one rank and drives one device.

Worker mode (one per rank):

  python -m staticfusion_tpu_torch.apps.run_multihost --store PATH \
      --num-processes N --process-id I --n-pix A --n-map B --frames M

(`--coordinator host:port` in place of `--store` meets over a TCPStore
served by process 0.)  Spawn mode starts N workers on this machine over a
FileStore in a temporary directory and prints worker 0's output:

  python -m staticfusion_tpu_torch.apps.run_multihost --spawn N ...

Every rank feeds the same synthetic frame stream (SPMD); the sharded step
divides image rows over `pix` and surfel slots over `map`, with Gloo
collectives between the ranks.  Each rank prints its per-frame poses and
the final error for cross-rank consistency checks
(tests/test_torch_multihost.py), and a STATS line: slots owned, surfels
held, pixels in its row block, kernel launches, collective calls and
bytes, median ms/frame.  `--device` is the card by default
(`--device cpu` runs the plain versions); ranks of one host may share a
card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)


def _launches() -> dict:
    """This process's kernel launches (the wrappers' counts)."""
    from staticfusion_tpu_torch.kernels.bilateral import preprocess_depth_cuda
    from staticfusion_tpu_torch.kernels.irls import solve_irls_cuda
    from staticfusion_tpu_torch.kernels.smallsolve import (spd_inverse_cuda,
                                                           spd_solve_cuda)
    return {"preprocess_depth": preprocess_depth_cuda.launches,
            "spd_solve": spd_solve_cuda.launches,
            "spd_inverse": spd_inverse_cuda.launches,
            "irls_solve": solve_irls_cuda.launches}


def worker(args) -> None:
    import torch

    from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                               SFConfig)
    from staticfusion_tpu_torch.io import synthetic
    from staticfusion_tpu_torch.parallel import distributed as dist

    rt = dist.initialize(store_path=args.store, coordinator=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id, device=args.device)
    n = rt.num_processes
    print(f"proc {rt.process_id}/{n}: 1 local / {n} global devices "
          f"({rt.device})", flush=True)

    config = SFConfig(camera=CameraConfig(width=args.width,
                                          height=args.height),
                      fusion=FusionConfig(capacity=args.capacity))
    frames, gt = synthetic.make_sequence(config, args.frames, TWIST)

    slam = dist.DistributedSlam(config, args.n_pix, args.n_map,
                                device=rt.device, runtime=rt)
    cuda = rt.device.type == "cuda"
    ms = []
    for i, (rgb, depth_mm, _) in enumerate(frames):
        t0 = time.perf_counter()
        pose = slam.process(rgb, depth_mm)
        if cuda:
            torch.cuda.synchronize(rt.device)
        ms.append(1e3 * (time.perf_counter() - t0))
        if pose is not None:
            print(f"POSE {i} " + " ".join(f"{v:.6f}" for v in pose.ravel()),
                  flush=True)
    err = np.linalg.norm(slam.poses[-1][:3, 3] - gt[-1][:3, 3])
    mesh, smap = slam.mesh, slam.state.smap
    rows = mesh.rows(config.rows)
    print("STATS " + json.dumps({
        "rank": mesh.rank, "pix": mesh.pix, "map": mesh.map,
        "slots": list(mesh.slots(smap.capacity * mesh.n_map)),
        "surfels": int(smap.count()), "used": int(smap.used),
        "device": str(smap.pos.device),
        "surfels_total": int(slam.outputs.surfel_count),
        "rows": list(rows), "pixels": (rows[1] - rows[0]) * config.cols,
        "launches": _launches(), "comm": mesh.comm,
        "work": {f"{k[0]} {k[1]}": v for k, v in mesh.work.items()},
        "ms_per_frame": ms}), flush=True)
    print(f"FINAL err_vs_gt={err:.6f}", flush=True)


def spawn(args) -> int:
    """Start args.spawn workers over a FileStore in a temporary directory;
    worker 0's output goes to ours.  A worker that fails ends the rest."""
    with tempfile.TemporaryDirectory(prefix="sf_multihost_") as tmp:
        base = [sys.executable, "-m", "staticfusion_tpu_torch.apps.run_multihost",
                "--store", os.path.join(tmp, "store"),
                "--num-processes", str(args.spawn),
                "--n-pix", str(args.n_pix), "--n-map", str(args.n_map),
                "--frames", str(args.frames), "--width", str(args.width),
                "--height", str(args.height),
                "--capacity", str(args.capacity), "--device", args.device]
        procs = [subprocess.Popen(
            base + ["--process-id", str(i)],
            stdout=None if i == 0 else subprocess.DEVNULL,
            stderr=None if i == 0 else subprocess.DEVNULL)
            for i in range(args.spawn)]
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return max(abs(p.returncode) for p in procs)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn N local worker processes")
    ap.add_argument("--store", default=None,
                    help="FileStore path the ranks meet at")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of a TCPStore served by process 0")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--n-pix", type=int, default=1)
    ap.add_argument("--n-map", type=int, default=2)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=1 << 14)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.spawn:
        return spawn(args)
    worker(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
