"""Loop closure in the port against the JAX package on the same inputs
(CPU, 160x120, the tests/test_keyframes.py configuration): the keyframe DB
(fingerprint, add_keyframe, query, halve_db), relative_pose with and
without T_init, the averaging median, deform_map, close_loop, the
KeyframeDB carried across, and SlamSystem._maybe_close_loop as a whole.

Tolerances: fingerprints, DB contents and the map deformation agree at
1e-5 (the same float32 formulas in another evaluation order); close_loop's
poses at 1e-5; relative_pose's transform at 1e-4 and its residual at
1e-5 (one coarse-to-fine solve on identical inputs, eager here and jitted
in JAX; measured 5e-7 and 3e-7, against residual gates of 0.03-0.05);
closure decisions exactly.
The slice test steps one keyframe tick of the 16-frame out-and-back
(test_loop_closure_fires_in_pipeline's) on both packages from one state:
a port run supplies the state of frames 0..8, a JAX SlamSystem holds it,
and the port's system takes the JAX system's state and DB through
state_from_numpy (running JAX's own steps
first would cost minutes of compilation on the CPU).  Both must accept
the same closure with the same T_rel (1e-4), and give the same corrected
trajectory, keyframe poses and deformed map (1e-4).  Last, the 16-frame
run on the port alone must close a loop with ATE < 0.03, the JAX test's
gates; and with closures off, chain smoothing must engage and keep the
trajectory accurate (test_chain_smoothing_engages_and_stays_accurate's
gates).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from staticfusion_tpu.config import (CameraConfig, FusionConfig,
                                     LoopClosureConfig, SFConfig)
from staticfusion_tpu.io import synthetic
from staticfusion_tpu.pipeline import keyframes as jkf
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.pipeline import keyframes as tkf

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120),
                  fusion=FusionConfig(capacity=1 << 16))
TCONFIG = TorchConfig.from_json(CONFIG.to_json())
# tests/test_keyframes.py::test_loop_closure_fires_in_pipeline's loop.
LOOP = CONFIG.replace(loop=LoopClosureConfig(
    enabled=True, kf_interval=2, capacity=16, min_gap=5, max_fp_dist=0.005,
    max_residual=0.05))
TLOOP = TorchConfig.from_json(LOOP.to_json())
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
TOL = 1e-5
SOLVE_TOL = 1e-4
RESID_TOL = 1e-5


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test."""
    yield
    jax.clear_caches()


def T(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[T(v) for v in x])
    return torch.tensor(np.array(x))


def close(got, want, tol=TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=tol)


def _intensity(rgb):
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2]).astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    """(intensity, depth in metres) of 6 frames of the synthetic forward
    sequence."""
    fr, _ = synthetic.make_sequence(CONFIG, 6, TWIST)
    return [(_intensity(rgb), (d / 1000.0).astype(np.float32))
            for rgb, d, _ in fr]


def _dbs(frames, n_add, capacity=8):
    jdb = jkf.empty_db(capacity, CONFIG.rows, CONFIG.cols)
    tdb = tkf.empty_db(capacity, CONFIG.rows, CONFIG.cols)
    for i in range(n_add):
        inten, depth = frames[i % len(frames)]
        inten = inten + np.float32(0.001 * i)
        pose = synthetic_pose(i)
        jdb = jkf.add_keyframe(jdb, jnp.asarray(inten), jnp.asarray(depth),
                               jnp.asarray(pose), i * 10)
        tdb = tkf.add_keyframe(tdb, T(inten), T(depth), T(pose), i * 10)
    return jdb, tdb


def synthetic_pose(i):
    from staticfusion_tpu_torch.geometry.se3 import se3_exp
    return se3_exp(torch.as_tensor(TWIST * (i + 1))).numpy()


def _same_db(tdb, jdb):
    for f in jdb._fields:
        if f in ("frame_idx", "count"):
            np.testing.assert_array_equal(np.asarray(getattr(tdb, f)),
                                          np.asarray(getattr(jdb, f)))
        else:
            close(getattr(tdb, f), getattr(jdb, f))


def test_fingerprint(frames):
    for inten, depth in (frames[0], frames[5], (frames[0][0] * 1.3,
                                                frames[0][1])):
        close(tkf.fingerprint(T(inten), T(depth)),
              jkf.fingerprint(jnp.asarray(inten), jnp.asarray(depth)))
    assert tkf.fp_dim() == jkf.fp_dim()


def test_add_keyframe_clamps_at_capacity(frames):
    """Nine adds into eight slots: the last one lands in the last slot."""
    jdb, tdb = _dbs(frames, 9)
    _same_db(tdb, jdb)
    assert int(tdb.count) == 8 and int(tdb.frame_idx[7]) == 80


@pytest.mark.parametrize("case", ["revisit", "min_gap", "none_eligible"])
def test_query(frames, case):
    jdb, tdb = _dbs(frames, 6)
    inten, depth = frames[0] if case != "min_gap" else frames[5]
    if case == "revisit":
        inten = inten * 1.1
    cur = {"revisit": 100, "min_gap": 51, "none_eligible": 5}[case]
    jb, jd = jkf.query(jdb, jkf.fingerprint(jnp.asarray(inten),
                                            jnp.asarray(depth)), cur, 30)
    tb, td = tkf.query(tdb, tkf.fingerprint(T(inten), T(depth)), cur, 30)
    assert int(tb) == int(jb)
    if case == "none_eligible":
        assert float(td) == float(jd) == float("inf")
    else:
        close(td, jd, tol=1e-6, rtol=1e-5)
        assert np.isfinite(float(td))


def test_halve_db(frames):
    jdb, tdb = _dbs(frames, 8)
    jh, th = jkf.halve_db(jdb), tkf.halve_db(tdb)
    _same_db(th, jh)
    np.testing.assert_array_equal(th.frame_idx.numpy(),
                                  [0, 20, 40, 60, -1, -1, -1, -1])


def test_keyframe_db_carried_both_ways(frames):
    from staticfusion_tpu_torch.pipeline.state import (state_from_numpy,
                                                       state_to_numpy)
    jdb, _ = _dbs(frames, 5)
    tdb = state_from_numpy(jax.tree_util.tree_map(np.asarray, jdb),
                           device="cpu", cls=tkf.KeyframeDB)
    assert isinstance(tdb, tkf.KeyframeDB)
    assert tdb.frame_idx.dtype == torch.int32
    back = state_to_numpy(tdb)
    for f in jdb._fields:
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(jdb, f)))


@pytest.mark.parametrize("case", ["even", "odd", "all_nan"])
def test_nanmedian_averages_the_middle_pair(case):
    """jnp.nanmedian averages the two middle values of an even count;
    torch.nanmedian would take the lower one."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, 60).astype(np.float32)
    x[rng.random(60) < 0.3] = np.nan
    n = int((~np.isnan(x)).sum())
    if (case == "even") != (n % 2 == 0):
        x[np.flatnonzero(~np.isnan(x))[0]] = np.nan
    if case == "all_nan":
        x[:] = np.nan
    got = float(tkf.nanmedian(torch.as_tensor(x)))
    want = float(jnp.nanmedian(jnp.asarray(x)))
    if case == "all_nan":
        assert np.isnan(got) and np.isnan(want)
        return
    assert got == want
    v = np.sort(x[~np.isnan(x)])
    if case == "even":
        assert got != float(torch.nanmedian(torch.as_tensor(x)))
        assert got == np.float32(0.5 * v[len(v) // 2 - 1]
                                 + 0.5 * v[len(v) // 2])


def _seed_guess():
    """A wide-baseline guess for frames 0 -> 2 (truth exp(2 TWIST)), off by
    5 cm and ~3 degrees."""
    from staticfusion_tpu_torch.geometry.se3 import se3_exp
    off = np.array([0.05, -0.03, 0.02, 0.03, 0.04, -0.02], np.float32)
    return se3_exp(torch.as_tensor(2 * TWIST + off)).numpy()


@pytest.mark.parametrize("seeded", [False, True])
def test_relative_pose(frames, jax_side, seeded):
    """kf_T_cur between frames 0 and 2, from identity and seeded."""
    from staticfusion_tpu_torch.geometry.se3 import se3_exp
    (ki, kd), (ci, cd) = frames[0], frames[2]
    T_init = T(_seed_guess()) if seeded else None
    jT, jr = jax_side["relative_pose"][seeded]
    tT, tr = tkf.relative_pose(T(ki), T(kd), T(ci), T(cd), TLOOP,
                               T_init=T_init)
    close(tT, jT, tol=SOLVE_TOL)
    close(tr, jr, tol=RESID_TOL)
    truth = se3_exp(torch.as_tensor(2 * TWIST)).numpy()
    assert np.abs(tT.numpy() - truth).max() < 5e-3
    assert float(tr) < 0.05


def test_deform_map():
    """Random map, keyframes born at frames 0, 10, 20 of 4 rows (3 live),
    random corrections: surfels move with their birth interval, invalid
    slots stay."""
    from staticfusion_tpu.fusion.surfels import empty_map as jempty
    rng = np.random.default_rng(4)
    n = 64
    smap = jempty(n)
    valid = rng.random(n) < 0.8
    smap = smap._replace(
        pos=jnp.asarray(rng.normal(0, 2, (n, 3)).astype(np.float32)),
        normal=jnp.asarray(rng.normal(0, 1, (n, 3)).astype(np.float32)),
        init_time=jnp.asarray(rng.integers(0, 30, n).astype(np.float32)),
        valid=jnp.asarray(valid), used=jnp.asarray(n, jnp.int32))
    fidx = np.array([0, 10, 20, -1], np.int32)
    old = np.stack([synthetic_pose(3 * i) for i in range(4)])
    new = np.stack([synthetic_pose(3 * i + 1) for i in range(4)])
    new[0] = old[0]
    want = jkf.deform_map(smap, jnp.asarray(fidx), jnp.asarray(old),
                          jnp.asarray(new), 3)
    got = tkf.deform_map(T(smap), T(fidx), T(old), T(new), 3)
    close(got.pos, want.pos)
    close(got.normal, want.normal)
    close(got.pos[~valid], np.asarray(smap.pos)[~valid], tol=0)
    moved = np.abs(got.pos.numpy() - np.asarray(smap.pos)).max(1) > 1e-4
    assert moved[valid & (np.asarray(smap.init_time) >= 10)].all()


def test_close_loop():
    """A drifted 8-keyframe chain in a 16-row DB and the exact loop
    constraint 0 -> 7 (tests/test_keyframes.py::test_close_loop_removes
    _drift's setup)."""
    from staticfusion_tpu_torch.geometry.se3 import se3_exp
    rng = np.random.default_rng(3)
    xi = rng.normal(0, 0.05, (7, 6)).astype(np.float32)
    bias = np.array([0.01, 0.004, -0.006, 0, 0, 0], np.float32)
    gt = [np.eye(4, dtype=np.float32)]
    drifted = [np.eye(4, dtype=np.float32)]
    for k in range(7):
        gt.append(gt[-1] @ se3_exp(torch.as_tensor(xi[k])).numpy())
        drifted.append(drifted[-1] @ se3_exp(
            torch.as_tensor(xi[k] + bias)).numpy())
    poses = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    poses[:8] = np.stack(drifted)
    T_07 = np.linalg.inv(gt[0]) @ gt[7]
    want = np.asarray(jkf.close_loop(jnp.asarray(poses), 8, 0, 7,
                                     jnp.asarray(T_07), 4.0, 10))
    got = tkf.close_loop(T(poses), 8, 0, 7, T(T_07), 4.0, 10).numpy()
    close(got, want)
    assert (np.linalg.norm(got[7, :3, 3] - gt[7][:3, 3])
            < 0.4 * np.linalg.norm(drifted[7][:3, 3] - gt[7][:3, 3]))


def _out_and_back(cfg, n=16):
    """test_loop_closure_fires_in_pipeline's sequence: 8 frames out along
    TWIST, then back."""
    from staticfusion_tpu_torch.geometry.se3 import se3_exp
    from staticfusion_tpu_torch.io.synthetic import (default_world,
                                                     render_frame)
    planes, _ = default_world()
    dT = se3_exp(torch.as_tensor(TWIST)).numpy()
    dT_inv = np.linalg.inv(dT).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    gt, frames = [], []
    for i in range(n):
        frames.append(render_frame(pose, cfg, planes))
        gt.append(pose.copy())
        pose = (pose @ (dT if i < n // 2 else dT_inv)).astype(np.float32)
    return frames, np.stack(gt)


def _leaves(node):
    if isinstance(node, tuple):
        return [x for v in node for x in _leaves(v)]
    return [node]


@pytest.fixture(scope="module")
def jax_side(frames):
    """Every call this module makes into JAX's relative_pose, in one
    place: the jitted solve traces once per variant (with and without
    T_init), where a trace per test would cost ~6 s each.

    relative_pose: {seeded: (T, residual)} for frames 0 -> 2.
    slice: a port run over frames 0..8 of the out-and-back and the step of
    frame 9 give the state before that tick's closure; a JAX SlamSystem
    holds it (its state, DB and trajectory are kept as numpy trees in
    `before`) and runs its _maybe_close_loop."""
    from staticfusion_tpu.pipeline.state import init_state as jinit
    from staticfusion_tpu.pipeline.step import (Frame as JFrame,
                                                StepOutputs as JOut)
    from staticfusion_tpu.pipeline.system import SlamSystem as JaxSlam
    from staticfusion_tpu_torch.pipeline import system as tsystem
    from staticfusion_tpu_torch.pipeline.state import state_to_numpy

    (ki, kd), (ci, cd) = [tuple(jnp.asarray(a) for a in f)
                          for f in (frames[0], frames[2])]
    # LOOP, the slice's config: relative_pose's config is a static jit
    # argument, so another one would trace and compile anew.
    rel = {False: jkf.relative_pose(ki, kd, ci, cd, LOOP),
           True: jkf.relative_pose(ki, kd, ci, cd, LOOP,
                                   T_init=jnp.asarray(_seed_guess()))}
    rel = {k: tuple(np.asarray(a) for a in v) for k, v in rel.items()}

    seq, _ = _out_and_back(TLOOP)
    tick = 9   # recorded frame 8: the run's first closure (keyframe 2)
    src = tsystem.SlamSystem(TLOOP, device="cpu")
    for i in range(tick):
        src.process(seq[i][0], seq[i][1], i / 30.0)
    assert src.loop_closures == [] and len(src.times) == tick - 1
    rgb, depth = (np.asarray(a, np.float32) for a in seq[tick][:2])
    src.state, out = tsystem.slam_step(src.state, src._to_frame(rgb, depth),
                                       TLOOP)
    src._maybe_resize_map()
    src._materialize_raw_poses()
    js = JaxSlam(LOOP)
    js.state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jinit(LOOP)),
        [jnp.asarray(a) for a in _leaves(state_to_numpy(src.state))])
    js._kf_db = jkf.KeyframeDB(*[jnp.asarray(a) for a in
                                 state_to_numpy(src._kf_db)])
    js._kf_stride = src._kf_stride
    js.times = list(src.times)
    js.poses = [p.copy() for p in src.poses]
    before = dict(state=jax.tree_util.tree_map(np.asarray, js.state),
                  db=jax.tree_util.tree_map(np.asarray, js._kf_db),
                  times=list(js.times), poses=[p.copy() for p in js.poses],
                  stride=js._kf_stride, smap_pos=src.state.smap.pos.numpy())
    pose = out.curr_pose.numpy()
    jo = js._maybe_close_loop(
        JFrame(rgb=jnp.asarray(rgb), depth_mm=jnp.asarray(depth)),
        JOut(jnp.asarray(pose), *[None] * 7))
    return {"relative_pose": rel,
            "slice": dict(tick=tick, rgb=rgb, depth=depth, pose=pose,
                          before=before, js=js, jo=jo)}


def test_maybe_close_loop_matches_jax(jax_side):
    from staticfusion_tpu_torch.pipeline import system as tsystem
    from staticfusion_tpu_torch.pipeline.state import state_from_numpy
    from staticfusion_tpu_torch.pipeline.step import StepOutputs

    sl = jax_side["slice"]
    before, js, jo, tick = sl["before"], sl["js"], sl["jo"], sl["tick"]
    # The port's system takes the JAX system's state and DB.
    ps = tsystem.SlamSystem(TLOOP, device="cpu")
    ps.state = state_from_numpy(before["state"], device="cpu")
    ps._kf_db = state_from_numpy(before["db"], device="cpu",
                                 cls=tkf.KeyframeDB)
    ps._kf_stride = before["stride"]
    ps.times = list(before["times"])
    ps.poses = [p.copy() for p in before["poses"]]
    to = ps._maybe_close_loop(
        tsystem.Frame(rgb=torch.tensor(sl["rgb"]),
                      depth_mm=torch.tensor(sl["depth"])),
        StepOutputs(torch.tensor(sl["pose"]), *[None] * 7))

    assert len(ps.loop_closures) == len(js.loop_closures) == 1
    (tc,), (jc,) = ps.loop_closures, js.loop_closures
    assert (tc["frame"], tc["keyframe"]) == (jc["frame"], jc["keyframe"]) \
        == (tick - 1, 2)
    close(tc["T_rel"], jc["T_rel"], tol=SOLVE_TOL)
    close(tc["fp_dist"], jc["fp_dist"], tol=1e-6, rtol=1e-5)
    close(tc["residual"], jc["residual"], tol=RESID_TOL)
    for key in ("correction_m", "budget_m", "gap_m"):
        close(tc[key], jc[key], tol=SOLVE_TOL)
    close(to.curr_pose, jo.curr_pose, tol=SOLVE_TOL)
    close(ps.state.curr_pose, js.state.curr_pose, tol=SOLVE_TOL)
    assert len(ps.poses) == len(js.poses) == tick - 1
    for tp, jp in zip(ps.poses, js.poses):
        close(tp, jp, tol=SOLVE_TOL)
    tm, jm = ps.state.smap, js.state.smap
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    close(tm.pos, jm.pos, tol=SOLVE_TOL)
    close(tm.normal, jm.normal, tol=SOLVE_TOL)
    tdb, jdb = ps._kf_db, js._kf_db
    np.testing.assert_array_equal(tdb.frame_idx.numpy(),
                                  np.asarray(jdb.frame_idx))
    assert int(tdb.count) == int(jdb.count) == 5
    close(tdb.poses, jdb.poses, tol=SOLVE_TOL)
    close(tdb.emb, jdb.emb)
    # The correction moved the map and the trajectory.
    assert np.abs(tm.pos.numpy() - before["smap_pos"]).max() > 1e-4


def test_port_alone_closes_the_out_and_back():
    """The JAX test's gates through the port alone: at least one closure,
    each at least min_gap frames after its keyframe and under the
    residual gate, and ATE < 0.03 over the corrected trajectory."""
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    frames, gt = _out_and_back(TLOOP)
    slam = SlamSystem(TLOOP, device="cpu")
    for i, (rgb, depth_mm, _) in enumerate(frames):
        slam.process(rgb, depth_mm, i / 30.0)
    assert len(slam.loop_closures) >= 1, "no loop closure detected"
    for c in slam.loop_closures:
        assert c["frame"] - c["keyframe"] >= TLOOP.loop.min_gap
        assert c["residual"] < TLOOP.loop.max_residual
    ate = slam.ate(np.arange(len(frames)) / 30.0, gt)
    assert ate < 0.03, f"ATE {ate} after loop closure"


def test_port_chain_smoothing_engages_and_stays_accurate():
    """tests/test_keyframes.py::test_chain_smoothing_engages_and_stays_
    accurate through the port: with the fingerprint gate shut (no
    closures), skip constraints measured every keyframe tick correct the
    chain, each under the residual gate, and a 14-frame forward run stays
    within ATE 0.03."""
    from staticfusion_tpu_torch.config import LoopClosureConfig
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    cfg = TCONFIG.replace(loop=LoopClosureConfig(
        enabled=True, kf_interval=2, capacity=16, min_gap=5,
        max_fp_dist=0.0, max_residual=0.05, smooth_skip=2))
    frames, gt = _out_and_back(cfg, 28)
    frames, gt = frames[:14], gt[:14]   # the forward leg only
    slam = SlamSystem(cfg, device="cpu")
    for i, (rgb, depth_mm, _) in enumerate(frames):
        slam.process(rgb, depth_mm, i / 30.0)
    assert slam.loop_closures == []
    assert len(slam.chain_smoothings) >= 2, slam.chain_smoothings
    for s in slam.chain_smoothings:
        assert s["residual"] < cfg.loop.max_residual
    ate = slam.ate(np.arange(14) / 30.0, gt)
    assert ate < 0.03, f"ATE {ate} with chain smoothing"
