"""The whole per-frame slice: the port's SlamSystem against the JAX one on
the tests/test_e2e.py setup (160x120, capacity 1<<16), over 5 frames.

Two comparisons:
* stepped: each port step starts from the JAX state of the previous frame
  (carried across with state_from_numpy), so per-frame differences cannot
  accumulate — poses agree within 2e-3 (one IRLS step; typically ~1e-6);
* free-running: both systems run on their own.  At F=4 a surfel made at
  pixel centre u projects to texel 4(u + 0.5), an exact texel boundary, so
  last-bit float differences move some surfels one texel; the re-rendered
  prediction then differs at a few percent of pixels and the coupled
  solver's convergence tests can flip.  The runs stay equally accurate
  (both ATEs < 2 cm) while their poses drift apart by up to ~1e-2.
"""

import numpy as np
import pytest
import torch

import jax

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.io import synthetic
from staticfusion_tpu.pipeline.system import SlamSystem as JaxSlam
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.pipeline import step as tstep
from staticfusion_tpu_torch.pipeline.state import (state_from_numpy,
                                                   state_to_numpy)
from staticfusion_tpu_torch.pipeline.system import SlamSystem as TorchSlam

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120),
                  fusion=FusionConfig(capacity=1 << 16))
TCONFIG = TorchConfig.from_json(CONFIG.to_json())
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
N = 5
STEP_POSE_TOL = 2e-3
FREE_POSE_TOL = 2e-2


@pytest.fixture(scope="module")
def runs():
    frames, gt = synthetic.make_sequence(CONFIG, N, TWIST)
    js, ts = JaxSlam(CONFIG), TorchSlam(TCONFIG, device="cpu")
    jout, tout, jstates = [], [], []
    for i, (rgb, d, _) in enumerate(frames):
        jout.append(js.process(rgb, d, i / 30.0))
        tout.append(ts.process(rgb, d, i / 30.0))
        jstates.append(None if js.state is None else
                       jax.tree_util.tree_map(np.asarray, js.state))
    return frames, gt, js, ts, jout, tout, jstates


def _pose_diff(a, b):
    return float(np.abs(np.asarray(a) - b.numpy()).max())


def test_bootstrap_matches(runs):
    _, _, _, _, jout, tout, _ = runs
    assert _pose_diff(jout[1].curr_pose, tout[1].curr_pose) < STEP_POSE_TOL
    assert int(tout[1].surfel_count) == int(jout[1].surfel_count)
    np.testing.assert_allclose(tout[1].static_prob.numpy(),
                               np.asarray(jout[1].static_prob), atol=1e-5)


@pytest.mark.parametrize("k", range(2, N))
def test_stepped_from_jax_state(runs, k):
    """Frame k from the JAX state after frame k-1 (state_from_numpy)."""
    frames, _, _, _, jout, _, jstates = runs
    state = state_from_numpy(jstates[k - 1], device="cpu")
    rgb, d, _ = frames[k]
    _, out = tstep.slam_step(state, tstep.Frame(torch.as_tensor(rgb),
                                                torch.as_tensor(d)), TCONFIG)
    want = jout[k]
    assert _pose_diff(want.curr_pose, out.curr_pose) < STEP_POSE_TOL
    nj, nt = int(want.surfel_count), int(out.surfel_count)
    assert abs(nj - nt) <= 0.01 * nj, (nj, nt)
    assert float(np.mean(np.abs(out.static_prob.numpy()
                                - np.asarray(want.static_prob)))) < 1e-2
    assert bool(out.dense) == bool(want.dense)


def test_free_running_systems_agree(runs):
    _, gt, js, ts, jout, tout, _ = runs
    for a, b in zip(jout[1:], tout[1:]):
        assert _pose_diff(a.curr_pose, b.curr_pose) < FREE_POSE_TOL
        nj, nt = int(a.surfel_count), int(b.surfel_count)
        assert abs(nj - nt) <= 0.01 * nj, (nj, nt)
        assert float(np.mean(np.abs(b.static_prob.numpy()
                                    - np.asarray(a.static_prob)))) < 1e-2
    times = np.arange(N) / 30.0
    assert js.ate(times, gt) < 0.02
    assert ts.ate(times, gt) < 0.02
    assert ts.total_surfels() == int(tout[-1].surfel_count)


def test_state_numpy_round_trip(runs):
    """JAX state -> port state -> numpy keeps every leaf bit-exactly."""
    jstate = runs[6][3]
    back = state_to_numpy(state_from_numpy(jstate, device="cpu"))
    for got, want in zip(jax.tree_util.tree_leaves(tuple(back)),
                         jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _to_jax_tree(cls, node):
    """A port NamedTuple tree of numpy arrays -> the JAX package's types."""
    import jax.numpy as jnp

    from staticfusion_tpu.fusion.predict import PredictedView
    from staticfusion_tpu.fusion.surfels import SurfelMap
    from staticfusion_tpu.pipeline.state import RingBuffers

    nested = {"smap": SurfelMap, "rings": RingBuffers, "pred": PredictedView}
    return cls(**{f: (_to_jax_tree(nested[f], getattr(node, f))
                      if f in nested else jnp.asarray(getattr(node, f)))
                  for f in cls._fields})


@pytest.mark.parametrize("stale_every", [0, 3])
def test_tiering_and_archive_match_jax(runs, stale_every):
    """The host driver's re-tiering, watermark repack and stale-surfel
    archive split take the same decisions as the JAX driver on the same
    state (every `stale_every`-th surfel aged past the freshness window)."""
    from staticfusion_tpu.pipeline.state import SlamState as JaxState

    ts = runs[3]
    state = state_to_numpy(ts.state)
    if stale_every:
        last = state.smap.last_time.copy()
        last[::stale_every] = -1000.0
        state = state._replace(smap=state.smap._replace(last_time=last))
    js, ps = JaxSlam(CONFIG), TorchSlam(TCONFIG, device="cpu")
    js.state = _to_jax_tree(JaxState, state)
    ps.state = state_from_numpy(state, device="cpu")
    for s in (js, ps):
        s.archive_min_batch = 512
        s._frames_since_resize_check = s.resize_check_interval - 1
        s._maybe_resize_map()
    assert ps.state.smap.capacity == js.state.smap.capacity
    np.testing.assert_array_equal(ps.state.smap.valid.numpy(),
                                  np.asarray(js.state.smap.valid))
    np.testing.assert_array_equal(ps.state.smap.pos.numpy(),
                                  np.asarray(js.state.smap.pos))
    assert int(ps.state.smap.used) == int(js.state.smap.used)
    assert (ps.archive is None) == (js.archive is None) == (not stale_every)
    if stale_every:
        assert ps.archive.capacity == js.archive.capacity
        np.testing.assert_array_equal(ps.archive.pos.numpy(),
                                      np.asarray(js.archive.pos))
    assert ps.total_surfels() == js.total_surfels() == int(
        ts.state.smap.count())
    assert int(ps.full_map().count()) == ps.total_surfels()


def test_capacity_wall_and_watermark():
    """Capacity below the pixel count, a moving object and frequent checks
    (tests/test_e2e.py::test_map_full_watermark_compaction on the port):
    `used` never exceeds capacity, compaction reopens insert headroom, and
    tracking stays finite."""
    cfg = TorchConfig.from_json(SFConfig(
        camera=CameraConfig(width=160, height=120),
        fusion=FusionConfig(capacity=1 << 12)).to_json())
    sphere = synthetic.Sphere(center=np.array([0.3, 0.0, 1.8]), radius=0.35,
                              velocity=np.array([-0.05, 0.0, 0.0]))
    frames, _ = synthetic.make_sequence(cfg, 8, TWIST * 3.0, sphere=sphere)
    slam = TorchSlam(cfg, device="cpu", resize_check_interval=2)
    useds, counts = [], []
    for i, (rgb, d, _) in enumerate(frames):
        out = slam.process(rgb, d, i / 30.0)
        if out is not None:
            useds.append(int(slam.state.smap.used))
            counts.append(int(out.surfel_count))
            assert bool(torch.isfinite(out.curr_pose).all())
    cap = cfg.fusion.capacity
    assert all(u <= cap for u in useds) and all(c <= cap for c in counts)
    assert max(useds) == cap and min(useds) < cap, useds
    assert counts[-1] > 0.5 * cap, counts
    assert slam.capacity_events


def test_dynamic_object_segmented():
    """The moving sphere scores clearly more dynamic than the background
    and tracking survives it (tests/test_e2e.py's dynamic gate)."""
    sphere = synthetic.Sphere(center=np.array([0.3, 0.0, 1.8]), radius=0.35,
                              velocity=np.array([-0.04, 0.0, 0.0]))
    frames, gt = synthetic.make_sequence(CONFIG, 6, TWIST, sphere=sphere)
    slam = TorchSlam(TCONFIG, device="cpu")
    gaps = []
    for i, (rgb, d, dyn) in enumerate(frames):
        out = slam.process(rgb, d, i / 30.0)
        if out is not None and dyn.sum() > 100:
            sp = out.static_prob.numpy()
            gaps.append(sp[~dyn].mean() - sp[dyn].mean())
    assert len(gaps) >= 3
    assert np.mean(gaps[1:]) > 0.5, gaps
    assert slam.ate(np.arange(6) / 30.0, gt) < 0.03
