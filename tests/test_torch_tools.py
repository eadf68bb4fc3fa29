"""The port's evaluation tools (staticfusion_tpu_torch/apps: accuracy_bench,
check_closures, render_cache, seg_diag, r5_suite, calibrate_loop,
stream_feed, smoke_e2e) on the CPU, against the JAX package's scripts/
where a CPU run of them is cheap.

The scripts are loaded by path (scripts/ is not a package); nothing in
them changes.  JAX's `run_one` runs with `fixed_tiers=False`, the port's
only schedule, at tests/test_torch_batch.py's config (160x120, F=1,
capacity 1<<15, 8 frames, seed 0), where free-running runs of the two
packages agree within 2e-3 (at F=4 texel-boundary ties let them part by
up to ~8e-3).  seg_diag runs at its fixed QVGA size, so only the port runs
it here (a QVGA compile of the JAX step on the CPU is too heavy for this
suite): its aggregate is held against a numpy recomputation from its own
--save-probs file.  Each test renders into its own $SF_ADV_CACHE under
tmp_path: both generators cache under the same file names.
"""

import functools
import importlib.util
import inspect
import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from staticfusion_tpu_torch.apps import (accuracy_bench, calibrate_loop,
                                         check_closures, r5_suite,
                                         render_cache, run_camera, seg_diag,
                                         smoke_e2e, stream_feed)
from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                           LoopClosureConfig, SFConfig)
from staticfusion_tpu_torch.io import adversarial as tadv
from staticfusion_tpu_torch.io import stream
from tests.test_torch_package import BLOCKER

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
APPS = ("accuracy_bench", "check_closures", "render_cache", "seg_diag",
        "r5_suite", "calibrate_loop", "stream_feed", "smoke_e2e")
# run_one at tests/test_torch_batch.py's config.
PROFILES = ("walk_xyz", "static")
RUN = dict(factor=1, n_frames=8, res_factor=4, seed=0, capacity=1 << 15)
CONFIG_KEYS = ("profile", "index_factor", "frames", "post_factor",
               "route_factor", "lambda_reg", "seed", "res_factor", "loop",
               "smooth_skip", "capacity", "fixed_tiers")
ATE_MAX = 0.02
POSE_TOL = 2e-3
IOU_TOL = 0.02
TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test (what
    tests/conftest.py does per module), so the process's memory maps stay
    far below vm.max_map_count."""
    yield
    jax.clear_caches()


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- accuracy_bench -------------------------------------------------------

@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """{profile: (port row, JAX row)}, each package rendering into its
    own cache; both JAX runs share one set of executables."""
    jab = _load_script("accuracy_bench")
    out = {}
    for profile in PROFILES:
        pair = []
        for name, fn, kw in (("port", accuracy_bench.run_one,
                              {"device": "cpu"}),
                             ("jax", jab.run_one, {"fixed_tiers": False})):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("SF_ADV_CACHE", str(tmp_path_factory.mktemp(name)))
                pair.append(fn(profile, **RUN, **kw))
        out[profile] = pair
    jax.clear_caches()
    return out


@pytest.mark.parametrize("profile", PROFILES)
def test_run_one_row_matches_jax_config(rows, profile):
    port, ref = rows[profile]
    assert list(port) == list(ref)
    assert {k: port[k] for k in CONFIG_KEYS} == {k: ref[k]
                                                 for k in CONFIG_KEYS}
    assert port["fixed_tiers"] is False
    assert port["closures"] == ref["closures"] == 0
    assert port["closure_events"] == ref["closure_events"] == []
    assert json.loads(json.dumps(port)) == port


@pytest.mark.parametrize("profile", PROFILES)
def test_run_one_accuracy_matches_jax(rows, profile):
    port, ref = rows[profile]
    assert port["ate_rmse_m"] < ATE_MAX and ref["ate_rmse_m"] < ATE_MAX
    assert abs(port["ate_rmse_m"] - ref["ate_rmse_m"]) <= POSE_TOL
    assert abs(port["rpe_rmse_m"] - ref["rpe_rmse_m"]) <= POSE_TOL
    if ref["seg_iou"] is None:
        assert port["seg_iou"] is None
    else:
        assert abs(port["seg_iou"] - ref["seg_iou"]) <= IOU_TOL


def test_loop_row_records_survive_json(tmp_path, monkeypatch):
    """With loop closure on at 80x60, a keyframe every frame, a 4-slot DB
    and a 4096-slot map, the row's closure events, DB halvings and
    capacity events are plain JSON values: the row round-trips through
    json unchanged."""
    monkeypatch.setenv("SF_ADV_CACHE", str(tmp_path))
    monkeypatch.setattr(accuracy_bench, "LoopClosureConfig", functools.partial(
        LoopClosureConfig, kf_interval=1, capacity=4, min_gap=3))
    row = accuracy_bench.run_one("static", 1, 8, res_factor=8,
                                 capacity=1 << 12, loop=True, smooth_skip=1,
                                 device="cpu")
    assert row["loop"] is True and row["smooth_skip"] == 1
    assert row["closures"] >= 1 and row["smoothings"] >= 1
    assert row["db_halvings"] and row["capacity_events"]
    assert json.loads(json.dumps(row)) == row


def test_main_writes_the_rows_and_the_table(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SF_ADV_CACHE", str(tmp_path))
    out = tmp_path / "rows.json"
    rows = accuracy_bench.main(["--profiles", "static", "--factors", "1",
                                "--frames", "6", "--res-factor", "4",
                                "--device", "cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == rows
    assert [(r["profile"], r["index_factor"], r["frames"]) for r in rows] \
        == [("static", 1, 6)]
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == rows[0]
    r = rows[0]
    assert lines[-3:] == [
        "| profile | F | ATE RMSE (m) | RPE (m) | seg IoU | fps |",
        "|---|---|---|---|---|---|",
        f"| static | 1 | {r['ate_rmse_m']} | {r['rpe_rmse_m']} | None "
        f"| {r['fps']} |"]


@pytest.mark.parametrize("device", ["nonsense", "cuda"])
def test_main_refuses_a_device_it_cannot_use(device, tmp_path, monkeypatch):
    """An unknown device raises, and so does the card where there is
    none: no fallback to the CPU, and nothing rendered first."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    monkeypatch.setenv("SF_ADV_CACHE", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError):
        accuracy_bench.main(["--profiles", "static", "--frames", "4",
                             "--device", device])
    assert not (tmp_path / "cache").exists()


# --- check_closures -------------------------------------------------------

def test_check_closures_matches_jax(tmp_path, monkeypatch):
    """Closure events built from the ground truth with known translation
    offsets (2 cm: genuine; 0.7 m: false), and a row with none."""
    rf, n = 4, 12
    cfg = SFConfig(camera=CameraConfig(width=640 // rf, height=480 // rf))
    _, gt = tadv.make_adversarial_sequence(cfg, n, "walk_xyz", seed=1)
    events = []
    for kf, fr, dx, resid in ((2, 10, 0.02, 0.011), (3, 11, 0.7, 0.024)):
        rel = np.linalg.inv(gt[kf]) @ gt[fr]
        rel[0, 3] += dx
        events.append({"frame": fr, "keyframe": kf, "residual": resid,
                       "T_rel": rel.tolist()})
    base = {"profile": "walk_xyz", "frames": n, "seed": 1, "res_factor": rf}
    path = tmp_path / "ACC_closures.json"
    path.write_text(json.dumps([dict(base, closure_events=events),
                                dict(base, closure_events=[])]))
    summaries = []
    for name, check in (("port", check_closures.check),
                        ("jax", _load_script("check_closures").check)):
        monkeypatch.setenv("SF_ADV_CACHE", str(tmp_path / name))
        summaries.append(check(str(path)))
    port, ref = summaries
    assert port == ref
    assert [s["false_closures_gt_0p5m"] for s in port] == [1, 0]
    assert [s["closures"] for s in port] == [2, 0]
    assert port[0]["max_T_err_m"] == pytest.approx(0.7, abs=1e-4)
    assert port[1]["max_T_err_m"] is None


# --- render_cache ---------------------------------------------------------

def test_render_cache_writes_the_jax_names(tmp_path, monkeypatch):
    specs = ["static:3:0:8", "walk_xyz:2:1:8"]
    dirs = {}
    for name in ("port", "jax"):
        dirs[name] = tmp_path / name
        monkeypatch.setenv("SF_ADV_CACHE", str(dirs[name]))
        if name == "port":
            render_cache.main(specs)
        else:
            monkeypatch.setattr(sys, "argv", ["render_cache.py", *specs])
            _load_script("render_cache").main()
    names = sorted(p.name for p in dirs["port"].iterdir())
    assert len(names) == 2
    assert names == sorted(p.name for p in dirs["jax"].iterdir())
    cfg = SFConfig(camera=CameraConfig(width=80, height=60))
    for spec in specs:
        profile, n, seed = spec.split(":")[:3]
        frames, gt = tadv.make_adversarial_sequence(
            cfg, int(n), profile, seed=int(seed), cache_dir=str(dirs["port"]))
        key = f"adv_{profile}_{n}f_s{seed}_80x60_"
        (path,) = [dirs["port"] / p for p in names if p.startswith(key)]
        with np.load(path) as z:
            np.testing.assert_array_equal(z["gt"], gt)
            for i, f in enumerate(frames):
                for field, a in zip(("rgb", "depth", "dyn"), f):
                    np.testing.assert_array_equal(z[field][i], a)
        with np.load(dirs["jax"] / path.name) as z:
            np.testing.assert_allclose(z["gt"], gt, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(z["rgb"], np.stack(
                [f[0] for f in frames]))


# --- seg_diag -------------------------------------------------------------

def test_seg_diag_aggregate_matches_its_saved_probs(tmp_path, monkeypatch):
    monkeypatch.setenv("SF_ADV_CACHE", str(tmp_path))
    n = 6
    npz, out = tmp_path / "probs.npz", tmp_path / "seg.json"
    res = seg_diag.main(["--frames", str(n), "--device", "cpu",
                         "--save-probs", str(npz), "--json", str(out)])
    assert json.loads(out.read_text()) == res
    with np.load(npz) as z:
        probs, dyn, depth = z["probs"], z["dyn"], z["depth"]
    assert probs.shape == (n - 1, 240, 320) and np.isfinite(probs).all()
    stats = []
    for i in range(5, n):      # the temporal ring (buffer_length 5) is full
        if dyn[i].sum() <= 50:
            continue
        valid = depth[i] > 0
        pred = (probs[i - 1] < 0.5) & valid
        gtm = dyn[i] & valid
        tp, fp, fn = ((pred & gtm).sum(), (pred & ~gtm).sum(),
                      (~pred & gtm).sum())
        stats.append((tp / max(tp + fp + fn, 1), tp / max(tp + fp, 1),
                      tp / max(tp + fn, 1)))
    assert [r["frame"] for r in res["frames"]] == [5]
    agg = res["aggregate"]
    for k, key in enumerate(("iou", "precision", "recall")):
        assert agg[key] == round(float(np.mean([s[k] for s in stats])), 4)
    assert agg["frames"] == n and agg["ate_rmse_m"] < 0.05


# --- r5_suite -------------------------------------------------------------

@pytest.mark.parametrize("group", ["corridor", "corrlam", "vga", "walkvar"])
def test_r5_suite_plan_matches_jax(group, monkeypatch):
    """Record each suite's group (its run_one, emit and os.path.exists
    replaced) and compare the file names and run_one arguments, defaults
    applied; JAX's fixed_tiers has no counterpart.  With every file
    present, both skip the same runs."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    jr5 = _load_script("r5_suite")
    sigs = {"jax": inspect.signature(_load_script("accuracy_bench").run_one),
            "port": inspect.signature(accuracy_bench.run_one)}

    def record(name, exists):
        mod, drop = ((jr5, "fixed_tiers") if name == "jax"
                     else (r5_suite, "device"))
        emitted = []

        def emit(path, call):
            ba = sigs[name].bind(*call[0], **call[1])
            ba.apply_defaults()
            emitted.append((path, {k: v for k, v in ba.arguments.items()
                                   if k != drop}))
        with monkeypatch.context() as mp:
            mp.setattr(mod, "run_one", lambda *a, **kw: (a, kw))
            mp.setattr(mod, "emit", emit)
            mp.setattr(mod.os.path, "exists", lambda p: exists)
            if name == "jax":
                getattr(jr5, group)()
            else:
                r5_suite.run_group(group, device="cpu")
        return emitted

    plan = record("port", False)
    assert len(plan) == {"corridor": 8, "corrlam": 3, "vga": 8,
                         "walkvar": 12}[group]
    assert plan == record("jax", False)
    assert record("port", True) == record("jax", True) == (
        [] if group == "corridor" else plan)


# --- calibrate_loop -------------------------------------------------------

def test_calibrate_loop_populations_match_jax():
    """scripts/calibrate_loop.py's pairs through the JAX package, against
    the port's populations on the CPU."""
    import jax.numpy as jnp

    from staticfusion_tpu.config import CameraConfig as JCamera
    from staticfusion_tpu.config import SFConfig as JConfig
    from staticfusion_tpu.io import synthetic as jsyn
    from staticfusion_tpu.pipeline import keyframes as jkf
    from staticfusion_tpu.pipeline.step import _intensity

    cfg = JConfig(camera=JCamera(width=160, height=120))

    def pair(ii, di, ij, dj):
        fp = float(jnp.mean((jkf.fingerprint(ii, di)
                             - jkf.fingerprint(ij, dj)) ** 2))
        return fp, float(jkf.relative_pose(ii, di, ij, dj, cfg)[1])

    def prep(frame):
        return (_intensity(jnp.asarray(frame[0])),
                jnp.asarray(frame[1], jnp.float32) / 1000.0)

    def stats(twist, n, pairs):
        frames, _ = jsyn.make_sequence(cfg, n, np.asarray(twist, np.float32))
        return [pair(*prep(frames[i]), *prep(frames[j])) for i, j in pairs]

    ref_pos = stats([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], 10,
                    [(0, 1), (0, 2), (0, 3), (4, 6), (5, 8)])
    ref_neg = stats([0, 0, 0, 0, 0.1, 0], 14,
                    [(0, 9), (0, 12), (2, 11), (4, 13)])
    yy, xx = np.mgrid[0:cfg.rows, 0:cfg.cols].astype(np.float32)
    inten = jnp.asarray(0.5 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 7.0))
    da = jnp.asarray(1.5 + 1.0 * (xx / cfg.cols))
    db = da + 0.35 * np.sin(xx / 2.1) * np.sin(yy / 1.7)
    ref_neg.append(pair(inten, da, inten, jnp.asarray(db)))

    pos, neg = calibrate_loop.populations("cpu")
    assert len(pos) == 5 and len(neg) == 5
    for got, want in zip(pos + neg, ref_pos + ref_neg):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)


# --- stream_feed ----------------------------------------------------------

def test_stream_feed_file_matches_jax(tmp_path, monkeypatch):
    """Both feeders record the same header and frames to a file; only the
    timestamps (the send times) differ, and they rise."""
    argv = ["--frames", "3", "--fps", "0", "--width", "80", "--height", "60"]
    port, ref = tmp_path / "port.sfrd", tmp_path / "jax.sfrd"
    assert stream_feed.main(["--to", str(port), *argv]) == 3
    monkeypatch.setattr(sys, "argv", ["stream_feed.py", "--to", str(ref),
                                      *argv])
    _load_script("stream_feed").main()
    a, b = port.read_bytes(), ref.read_bytes()
    assert a[:16] == b[:16] and len(a) == len(b)
    readers = [stream.StreamReader(open(p, "rb")) for p in (port, ref)]
    try:
        assert [(r.version, r.width, r.height) for r in readers] == [
            (1, 80, 60)] * 2
        stamps = [[], []]
        for _ in range(3):
            fa, fb = (r.next_frame() for r in readers)
            stamps[0].append(fa[0])
            stamps[1].append(fb[0])
            for x, y in zip(fa[1:], fb[1:]):
                np.testing.assert_array_equal(x, y)
        assert all(r.next_frame() is None for r in readers)
    finally:
        for r in readers:
            r.f.close()
    for s in stamps:
        assert s == sorted(s) and len(set(s)) == 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_stream_feed_process_feeds_run_camera(tmp_path, monkeypatch,
                                              capsys):
    """stream_feed in a process of its own connects over tcp:// loopback
    to run_camera listening in this one (replay, on the CPU): 4 frames
    sent, 3 poses (the first frame waits for the bootstrap)."""
    monkeypatch.setattr(run_camera, "SFConfig", lambda: SFConfig(
        fusion=FusionConfig(capacity=1 << 17)))
    port = _free_port()
    feeder = subprocess.Popen(
        [sys.executable, "-m", "staticfusion_tpu_torch.apps.stream_feed",
         "--to", f"tcp://127.0.0.1:{port}", "--frames", "4", "--fps", "30"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        traj = tmp_path / "live.txt"
        run_camera.main(["--source", f"listen://{port}", "--replay",
                         "--device", "cpu", "--out", str(traj)])
        out, err = feeder.communicate(timeout=TIMEOUT)
    finally:
        feeder.kill()
        feeder.wait(TIMEOUT)
    assert feeder.returncode == 0, err
    assert out.strip() == f"streamed 4 frames to tcp://127.0.0.1:{port}"
    assert f"wrote 3 poses to {traj}" in capsys.readouterr().out
    assert len(traj.read_text().splitlines()) == 3


# --- smoke_e2e ------------------------------------------------------------

def test_smoke_e2e_matches_jax():
    """tests/test_e2e.py's shapes (160x120, F=4, capacity 1<<16, 8
    frames): both ATEs under 2 cm and within 2e-3 of each other."""
    port = smoke_e2e.main(["--device", "cpu"])
    assert port["static_prob"] == []
    ref = _load_script("smoke_e2e").main(n_frames=8)
    assert port["ate"] < ATE_MAX and ref < ATE_MAX
    assert abs(port["ate"] - ref) <= POSE_TOL


def test_smoke_e2e_dynamic_segments_the_sphere():
    res = smoke_e2e.main(["--device", "cpu", "--dynamic"])
    frames, on, off = zip(*res["static_prob"])
    assert frames == (2, 3, 4, 5, 6, 7)
    assert np.mean(on) < np.mean(off)
    assert res["ate"] < ATE_MAX


# --- every app without JAX ------------------------------------------------

_HELP = BLOCKER + r"""
import contextlib, io, json, runpy
out = {}
for app in sys.argv[1:]:
    buf = io.StringIO()
    sys.argv = [app, "--help"]
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("staticfusion_tpu_torch.apps." + app,
                             run_name="__main__")
            code = None
        except SystemExit as e:
            code = e.code
    leaked = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "staticfusion_tpu"))
    out[app] = {"code": code, "help": buf.getvalue(), "leaked": leaked}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def helps():
    """Every app's --help, run as __main__ in one process in which JAX and
    the JAX package cannot be imported."""
    proc = subprocess.run([sys.executable, "-c", _HELP, *APPS], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("app", APPS)
def test_app_answers_help_without_jax(helps, app):
    res = helps[app]
    assert res["code"] in (0, None) and res["leaked"] == []
    assert res["help"].startswith("usage:") and "--help" in res["help"]
