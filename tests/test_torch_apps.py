"""The port's command-line apps on the CPU: the synthetic-dataset exporter
against the JAX package's script, run_sequence end to end (trajectory,
PLY, metrics, checkpoint, a torch.profiler trace), a resumed run against
the uninterrupted one, a rawlog run, run_tum's defaults and result
numbering, and the viewer flags (--html, --viz, --live, --live-every).

8 frames written at 640x480 and run at 160x120 (--res-factor 4), map
capacity 1<<15, `--device cpu`.  Everything is written under pytest's
temporary directories (run_tum runs with that as its working directory);
the native I/O library is built by g++ into one of them.
"""

import base64
import functools
import json
import os
import pathlib
import re
import struct
import sys
import urllib.request

import numpy as np
import pytest
import torch

import jax

from staticfusion_tpu_torch.apps import (make_synthetic_dataset, run_sequence,
                                         run_tum)
from staticfusion_tpu_torch.config import FusionConfig
from staticfusion_tpu_torch.io import native
from staticfusion_tpu_torch.io.ply import load_ply_count
from staticfusion_tpu_torch.io.trajectory import (ate_rmse,
                                                  read_tum_trajectory)
from staticfusion_tpu_torch.kernels import _build
from staticfusion_tpu_torch.utils import checkpoint

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
N = 8
SPLIT = 5        # the checkpointed run processes frames [0, SPLIT)
CAPACITY = 1 << 15
BASE = ["--res-factor", "4", "--depth-scale", "5000", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _small_map_and_no_jax_caches(monkeypatch):
    """The apps build their config with FusionConfig(...): run them at a
    1<<15 map.  Drop JAX's executables after every test."""
    monkeypatch.setattr(run_sequence, "FusionConfig",
                        functools.partial(FusionConfig, capacity=CAPACITY))
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def sfio(tmp_path_factory):
    """The native I/O library, built into a temporary directory."""
    root = tmp_path_factory.mktemp("sfio")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "BUILD_DIR", root / "build")
        mp.setenv("XDG_CACHE_HOME", str(root / "cache"))
        native.load()
        yield native


@pytest.fixture(scope="module")
def dataset(sfio, tmp_path_factory):
    out = tmp_path_factory.mktemp("sfdata")
    make_synthetic_dataset.main([str(out), "--frames", str(N)])
    return out


def test_exporter_writes_the_scripts_files(dataset, tmp_path, monkeypatch):
    """The port's exporter and scripts/make_synthetic_dataset.py write the
    same files, byte for byte."""
    monkeypatch.syspath_prepend(str(REPO))
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py",
                                      str(tmp_path), "--frames", str(N)])
    from scripts.make_synthetic_dataset import main
    main()
    ours = sorted(p.relative_to(dataset) for p in dataset.rglob("*")
                  if p.is_file())
    theirs = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")
                    if p.is_file())
    assert ours == theirs and len(ours) == 2 * N + 2
    for rel in ours:
        assert (dataset / rel).read_bytes() == (tmp_path / rel).read_bytes()


def _run(dataset, out, *extra):
    """run_sequence into directory `out`; -> the paths it wrote."""
    out.mkdir(exist_ok=True)
    paths = {k: str(out / name) for k, name in (
        ("traj", "traj.txt"), ("ply", "map.ply"),
        ("metrics", "metrics.jsonl"), ("ckpt", "state.npz"))}
    run_sequence.main([str(dataset), *BASE, "--out", paths["traj"],
                       "--ply", paths["ply"], "--metrics", paths["metrics"],
                       "--checkpoint", paths["ckpt"], "--conf-threshold",
                       "0", *extra])
    return paths


@pytest.fixture(scope="module")
def full_run(dataset, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run_sequence, "FusionConfig",
                   functools.partial(FusionConfig, capacity=CAPACITY))
        return _run(dataset, tmp_path_factory.mktemp("full"))


def test_run_sequence_writes_its_outputs(dataset, full_run):
    t, poses = read_tum_trajectory(full_run["traj"])
    assert len(t) == N - 1     # frame 0 seeds the bootstrap
    gt_t, gt = read_tum_trajectory(str(dataset / "groundtruth.txt"))
    assert ate_rmse(t, poses, gt_t, gt) < 0.02
    rows = [json.loads(line) for line in open(full_run["metrics"])]
    frames = [r for r in rows if "frame" in r]
    assert [r["frame"] for r in frames] == list(range(1, N))
    assert all(r["surfels"] > 0 and r["fps"] > 0 for r in frames)
    assert rows[-1]["ate_rmse"] < 0.02 and rows[-1]["rpe_rmse"] < 0.02
    state = checkpoint.load_state(full_run["ckpt"], device="cpu")
    assert int(state.tick) == N
    assert checkpoint.load_config(full_run["ckpt"]).fusion.capacity == CAPACITY
    assert load_ply_count(full_run["ply"]) == int(
        ((state.smap.conf > 0) & state.smap.valid).sum())


def test_resume_continues_from_the_same_tick(dataset, full_run, tmp_path,
                                             capsys):
    """A run over frames [0, SPLIT) with --checkpoint, then --resume over
    the rest (an assoc file of frames SPLIT..N-1): the tick carries over
    and the resumed poses and map equal the uninterrupted run's."""
    first = _run(dataset, tmp_path / "a", "--max-frames", str(SPLIT))
    assert int(checkpoint.load_state(first["ckpt"], device="cpu").tick) \
        == SPLIT
    lines = (dataset / "rgbd_assoc.txt").read_text().splitlines()
    rest = tmp_path / "rest_assoc.txt"  # paths in it are the dataset's
    rest.write_text("\n".join(lines[SPLIT:]) + "\n")
    second = _run(dataset, tmp_path / "b", "--resume", first["ckpt"],
                  "--assoc", str(rest))
    assert f"(tick={SPLIT})" in capsys.readouterr().out
    t_full, p_full = read_tum_trajectory(full_run["traj"])
    t_res, p_res = read_tum_trajectory(second["traj"])
    assert len(t_res) == N - SPLIT
    np.testing.assert_array_equal(t_res, t_full[-(N - SPLIT):])
    np.testing.assert_allclose(p_res, p_full[-(N - SPLIT):], atol=1e-5)
    a = checkpoint.load_state(full_run["ckpt"], device="cpu")
    b = checkpoint.load_state(second["ckpt"], device="cpu")
    assert int(a.tick) == int(b.tick) == N
    assert int(a.smap.count()) == int(b.smap.count())
    assert load_ply_count(second["ply"]) == load_ply_count(full_run["ply"])


def test_profile_writes_a_torch_trace(dataset, tmp_path):
    run_sequence.main([str(dataset), *BASE, "--max-frames", "3",
                       "--out", str(tmp_path / "t.txt"),
                       "--profile", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_run_tum_defaults_and_numbering(dataset, tmp_path, monkeypatch):
    """run_tum sets --depth-scale 5000 and numbers its results
    odometry_results/experiment_NNN.txt in the working directory."""
    monkeypatch.chdir(tmp_path)
    for _ in range(2):
        run_tum.main([str(dataset), "--res-factor", "4", "--device", "cpu",
                      "--max-frames", "4"])
    res = sorted(os.listdir(tmp_path / "odometry_results"))
    assert res == ["experiment_000.txt", "experiment_001.txt"]
    t, poses = read_tum_trajectory(str(tmp_path / "odometry_results" /
                                       res[1]))
    gt_t, gt = read_tum_trajectory(str(dataset / "groundtruth.txt"))
    assert len(t) == 3 and ate_rmse(t, poses, gt_t, gt) < 0.02
    run_tum.main([str(dataset), "--res-factor", "4", "--device", "cpu",
                  "--max-frames", "3", "--out", str(tmp_path / "x.txt")])
    assert (tmp_path / "x.txt").exists()
    assert len(os.listdir(tmp_path / "odometry_results")) == 2


def test_rawlog_run_lands_in_the_raw_gt_frame(sfio, tmp_path):
    """run_sequence on a rawlog: the 180-degree stored orientation, the
    rotateByZ anchor and the rotateByZ export cancel, so the trajectory
    compares against the raw TUM ground truth."""
    from staticfusion_tpu_torch.config import CameraConfig, SFConfig
    from staticfusion_tpu_torch.io import rawlog, synthetic
    from staticfusion_tpu_torch.io.trajectory import pose_to_tum_line

    cfg = SFConfig(camera=CameraConfig(width=640, height=480))
    frames, gt = synthetic.make_sequence(cfg, 6, make_synthetic_dataset.TWIST)
    ts = [1341840000.0 + i / 30.0 for i in range(6)]
    path = str(tmp_path / "seq.rawlog")
    rawlog.write_rawlog(path, [(r, d / 1000.0) for r, d, _ in frames], ts)
    with open(tmp_path / "groundtruth.txt", "w") as f:
        f.write("# fixture\n")
        for t, p in zip(ts, gt):
            f.write(pose_to_tum_line(t, p) + "\n")
    traj = str(tmp_path / "traj.txt")
    run_sequence.main([path, "--res-factor", "4", "--device", "cpu",
                       "--out", traj])
    t_est, p_est = read_tum_trajectory(traj)
    assert len(t_est) == 5
    assert ate_rmse(t_est, p_est, np.asarray(ts), gt) < 0.02


def _png_shape(blob: bytes):
    """(height, width) of a PNG from its IHDR."""
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", blob[16:24])[::-1]


@pytest.mark.parametrize("flag", [
    pytest.param(["--html", "v.html"], id="html"),
    pytest.param(["--viz", "panels"], id="viz"),
    pytest.param(["--live", "0"], id="live"),
    pytest.param(["--live", "0", "--live-every", "3"], id="live_every")])
def test_viewer_flags_run(sfio, dataset, tmp_path, flag, capsys):
    """Each viewer flag runs and writes what the JAX app's does: the WebGL
    page with the map above the threshold and both trajectories, one panel
    mosaic per processed frame (decoded by the native decoder), or a live
    view refreshed every --live-every frames (default 5), still serving
    after the run until it is closed."""
    flag = [str(tmp_path / a) if a in ("v.html", "panels") else a
            for a in flag]
    viewer = run_sequence.main([str(dataset), *BASE, "--out",
                                str(tmp_path / "t.txt"), "--max-frames",
                                "7", *flag])
    try:
        printed = capsys.readouterr().out
        assert (tmp_path / "t.txt").exists()
        if flag[0] == "--html":
            html = (tmp_path / "v.html").read_text()
            assert "wrote web viewer to" in printed
            start = html.index("const DATA = ") + len("const DATA = ")
            data = json.loads(html[start:html.index(";\n", start)])
            assert len(data["trajs"]) == 2     # estimate and ground truth
            n_traj = len(base64.b64decode(data["trajs"][0]["pts"])) // 12
            assert n_traj == 6
            assert len(base64.b64decode(data["pos"])) > 0
        elif flag[0] == "--viz":
            names = sorted(os.listdir(tmp_path / "panels"))
            assert names == [f"frame_{i:05d}.png" for i in range(1, 7)]
            for name in names:
                img = native.decode_png(str(tmp_path / "panels" / name))
                assert img.shape == (240, 320, 3) and img.dtype == np.uint8
                assert img.any()
        else:
            every = 3 if "--live-every" in flag else 5
            m = re.search(r"live view: (http://127\.0\.0\.1:\d+)/", printed)
            assert m, "the app prints the live-view URL"
            base = m.group(1)
            met = json.loads(urllib.request.urlopen(
                base + "/metrics.json", timeout=5).read())
            assert met["frame"] == max(i for i in range(1, 7)
                                       if i % every == 0)
            assert met["surfels"] > 0 and set(met) == {
                "frame", "surfels", "fps", "conf", "depth_cutoff",
                "loop_closures"}
            png = urllib.request.urlopen(base + "/frame.png",
                                         timeout=5).read()
            # rgb | depth | model over weights | labels | model_img.
            assert _png_shape(png) == (2 * 120, 3 * 160)
            params = json.loads(urllib.request.urlopen(
                base + "/params.json", timeout=5).read())
            assert params == {"conf": 0.25, "depth": 4.5, "pause": False}
    finally:
        if viewer is not None:
            viewer.close()
    assert (viewer is None) == (flag[0] != "--live")


def test_loop_closure_flag_runs_and_prints_closures(dataset, tmp_path,
                                                    capsys):
    """--loop-closure runs the sequence with the keyframe DB on and prints
    the closure count.  The forward-only dataset revisits nothing, and at
    the default keyframe interval (10) its 7 recorded frames hold one
    tick: no closure."""
    traj = tmp_path / "t.txt"
    run_sequence.main([str(dataset), *BASE, "--out", str(traj),
                       "--loop-closure"])
    printed = capsys.readouterr().out
    assert "closed 0 loops" in printed.splitlines()
    t, poses = read_tum_trajectory(str(traj))
    gt_t, gt = read_tum_trajectory(str(dataset / "groundtruth.txt"))
    assert len(t) == N - 1 and ate_rmse(t, poses, gt_t, gt) < 0.02
    run_sequence.main([str(dataset), *BASE, "--out", str(traj),
                       "--max-frames", "3"])
    assert "closed" not in capsys.readouterr().out
