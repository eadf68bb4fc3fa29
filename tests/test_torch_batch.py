"""The port's batch path (process_batch) and per-frame records against the
JAX package (CPU, 160x120, index_factor=1).

`process_batch` runs 8 frames with resize_check_interval=3 in two calls
(frames 0-3, then 4-7): the bootstrap, chunks of 2, 3 and 1 frames, and a
tier check after every chunk.  Both systems run free, so their poses may
drift apart: stepped from the same state the port agrees with the JAX
step within 2e-3 (tests/test_torch_slice.py); free-running over 8 frames
at F=1 the poses stay within 2e-3 and the surfel counts within 0.1%, and
both ATEs stay under 2 cm.  What must agree exactly: which frames the tier
check ran after, the map tiers it chose, and the shape of the returned
static-probability stack.
"""

import numpy as np
import pytest
import torch

import jax

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.io import synthetic
from staticfusion_tpu.pipeline.system import SlamSystem as JaxSlam
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.pipeline.system import SlamSystem as TorchSlam

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120),
                  fusion=FusionConfig(capacity=1 << 15, index_factor=1))
TCONFIG = TorchConfig.from_json(CONFIG.to_json())
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
N = 8
SPLIT = 4           # first process_batch call: frames [0, SPLIT)
INTERVAL = 3
POSE_TOL = 2e-3
COUNT_TOL = 1e-3


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test (what
    tests/conftest.py does per module), so the process's memory maps stay
    far below vm.max_map_count."""
    yield
    jax.clear_caches()


def _spy_tier_checks(slam):
    """Record (frames processed, whether the check ran) at every call of
    the system's tier check: it ran iff it reset the frame counter."""
    calls = []
    inner = slam._maybe_resize_map

    def spy():
        inner()
        calls.append((len(slam.times),
                      slam._frames_since_resize_check == 0,
                      slam.state.smap.capacity))
    slam._maybe_resize_map = spy
    return calls


@pytest.fixture(scope="module")
def runs():
    frames, gt = synthetic.make_sequence(CONFIG, N, TWIST)
    rgbs = [f[0] for f in frames]
    depths = [f[1] for f in frames]
    ts = [i / 30.0 for i in range(N)]
    js = JaxSlam(CONFIG, resize_check_interval=INTERVAL)
    ps = TorchSlam(TCONFIG, device="cpu", resize_check_interval=INTERVAL)
    out = {}
    for name, s in (("jax", js), ("port", ps)):
        checks = _spy_tier_checks(s)
        probs = [s.process_batch(rgbs[:SPLIT], depths[:SPLIT], ts[:SPLIT],
                                 collect_prob=True),
                 s.process_batch(rgbs[SPLIT:], depths[SPLIT:], ts[SPLIT:],
                                 collect_prob=True)]
        probs = np.concatenate([np.asarray(p) for p in probs])
        out[name] = dict(slam=s, checks=checks, probs=probs)
    return out, gt


def test_batch_poses_and_ate(runs):
    out, gt = runs
    js, ps = out["jax"]["slam"], out["port"]["slam"]
    assert len(ps.poses) == len(js.poses) == N - 1
    assert ps.times == js.times
    times = np.arange(N) / 30.0
    assert js.ate(times, gt) < 0.02 and ps.ate(times, gt) < 0.02
    for pj, pt in zip(js.poses, ps.poses):
        assert np.abs(np.asarray(pj) - pt).max() < POSE_TOL


def test_batch_static_prob_stack(runs):
    out, _ = runs
    pj, pt = out["jax"]["probs"], out["port"]["probs"]
    assert pt.shape == pj.shape == (N - 1, CONFIG.rows, CONFIG.cols)
    assert np.isfinite(pt).all() and (pt >= 0).all() and (pt <= 1).all()
    assert float(np.mean(np.abs(pt - pj))) < 1e-2


def test_batch_tier_checks_and_counts(runs):
    out, _ = runs
    cj, cp = out["jax"]["checks"], out["port"]["checks"]
    # Bootstrap (frames 0+1, one record) leaves the counter at 1; then a
    # forced check after each chunk: after frames 2-3, 4-6 and 7.
    ran = [n for n, did, _ in cp if did]
    assert ran == [n for n, did, _ in cj if did] == [3, 6, 7]
    assert [c for *_, c in cp] == [c for *_, c in cj]
    assert len(cp) == len(cj) == 4
    mj, mp = out["jax"]["slam"].metrics, out["port"]["slam"].metrics
    assert [m["timestamp"] for m in mp] == [m["timestamp"] for m in mj]
    for a, b in zip(mj, mp):
        assert abs(a["surfels"] - b["surfels"]) <= COUNT_TOL * a["surfels"]
        assert a["dense"] == b["dense"]
    assert len(out["port"]["slam"].frame_seconds) == N - 1


def test_batch_matches_per_frame_process():
    """The port's batch path and its per-frame path give the same poses
    and counts when the per-frame path checks the tier on the batch's
    schedule (here: every frame of a one-frame chunk)."""
    frames, _ = synthetic.make_sequence(CONFIG, 5, TWIST)
    a = TorchSlam(TCONFIG, device="cpu", resize_check_interval=1)
    b = TorchSlam(TCONFIG, device="cpu", resize_check_interval=1)
    for i, (rgb, d, _) in enumerate(frames):
        a.process(rgb, d, i / 30.0)
    b.process_batch([f[0] for f in frames], [f[1] for f in frames],
                    [i / 30.0 for i in range(5)])
    for pa, pb in zip(a.poses, b.poses):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert a.metrics == b.metrics


def test_metrics_postmultiply_and_trajectory(runs, tmp_path):
    """metrics and write_trajectory against the JAX writer: the rows the
    JAX writer gives for the port's times and poses with pose_postmultiply
    applied once, less the frames whose ddt sum is exactly zero.  One
    frame's ddt sum is set to 0, as a repeated depth frame gives."""
    from staticfusion_tpu.io.trajectory import write_tum_trajectory
    run = runs[0]["port"]["slam"]
    ps = TorchSlam(TCONFIG, device="cpu")
    for f in ("times", "poses", "ddt_sums", "_pending_metrics"):
        setattr(ps, f, list(getattr(run, f)))
    ddt = [float(d) for d in ps.ddt_sums]
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    ps.pose_postmultiply = M
    ps.ddt_sums[2] = torch.zeros(())
    raw = [np.asarray(p) for p in ps.poses]
    ps._materialize_poses()
    ps._materialize_poses()  # a second read does not multiply again
    for p, r in zip(ps.poses, raw):
        np.testing.assert_array_equal(p, r @ M)
    path = tmp_path / "port.txt"
    ps.write_trajectory(str(path))
    keep = [i for i in range(N - 1) if i != 2]
    want = tmp_path / "jax.txt"
    write_tum_trajectory(str(want), [ps.times[i] for i in keep],
                         [raw[i] @ M for i in keep])
    assert path.read_text() == want.read_text()
    assert len(path.read_text().splitlines()) == N - 2
    m = ps.metrics
    assert [r["ddt_sum"] for r in m] == ddt and 0.0 not in ddt
    assert [r["surfels"] for r in m] == [
        int(r.surfel_count) for r in run._pending_metrics]
    assert set(m[0]) == {"timestamp", "surfels", "dense", "ddt_sum"}
