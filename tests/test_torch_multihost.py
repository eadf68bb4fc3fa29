"""The port's multi-process launcher (staticfusion_tpu_torch/apps/
run_multihost.py) on the CPU: real rank processes over a FileStore.

* 2 worker processes on a (1, 2) mesh against 1 process, 4 frames at
  80x64: the two ranks print the same poses (within 1e-6) and agree with
  the one-process run within 1e-4, as tests/test_multihost.py asserts of
  the JAX package;
* `--spawn 2` starts its own workers and prints worker 0's poses;
* `--device` defaults to the card, and without one the worker raises,
  naming device="cpu".

Each child gets a copy of the environment with OMP_NUM_THREADS=1 and is
killed if it outlives its timeout; the store lives under tmp_path.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from staticfusion_tpu_torch.apps import run_multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "staticfusion_tpu_torch.apps.run_multihost"
FRAMES = 4
TIMEOUT = 120

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(argv_per_proc):
    """Start one child per argv, wait for all; kill every child if one
    outlives TIMEOUT.  Returns the outputs; fails on a non-zero exit."""
    procs = [subprocess.Popen([sys.executable, "-m", MODULE] + argv,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=_env(), cwd=REPO)
             for argv in argv_per_proc]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return outs


def _parse_poses(text):
    poses = {}
    for line in text.splitlines():
        m = re.match(r"POSE (\d+) (.*)", line)
        if m:
            poses[int(m.group(1))] = np.asarray(
                [float(v) for v in m.group(2).split()]).reshape(4, 4)
    return poses


def _worker_argv(tmp_path, n):
    """The argv of each of n workers of a (1, n) mesh."""
    base = ["--store", str(tmp_path / f"store{n}"), "--num-processes",
            str(n), "--n-pix", "1", "--n-map", str(n), "--frames",
            str(FRAMES), "--device", "cpu"]
    return [base + ["--process-id", str(i)] for i in range(n)]


def test_two_processes_match_one_process(tmp_path):
    """The 2-rank run and the 1-rank run, all three processes at once."""
    outs = _run(_worker_argv(tmp_path, 2) + _worker_argv(tmp_path, 1))
    two, one = outs[:2], outs[2:]
    p0, p1 = _parse_poses(two[0]), _parse_poses(two[1])
    ref = _parse_poses(one[0])
    assert len(p0) == FRAMES - 1 and len(ref) == FRAMES - 1
    for k in ref:
        np.testing.assert_allclose(p0[k], p1[k], atol=1e-6)
        np.testing.assert_allclose(p0[k], ref[k], atol=1e-4)
    assert "proc 0/2: 1 local / 2 global devices" in two[0]
    assert "proc 1/2:" in two[1]
    for out in two + one:
        assert "FINAL err_vs_gt=" in out


def test_spawn_runs_its_own_workers():
    out = _run([["--spawn", "2", "--frames", "2", "--device", "cpu"]])[0]
    assert "proc 0/2:" in out
    assert len(_parse_poses(out)) == 1
    assert "FINAL err_vs_gt=" in out


def test_device_defaults_to_the_card(tmp_path):
    assert run_multihost.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_multihost.main(["--store", str(tmp_path / "store"),
                            "--num-processes", "1", "--n-map", "1"])
