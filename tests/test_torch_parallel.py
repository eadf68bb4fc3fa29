"""The port's multi-device layer (staticfusion_tpu_torch/parallel: mesh,
sharded, distributed, optimize_sharded) on the CPU, ranks as threads.

Each rank is a thread of this process with its own Gloo groups over one
HashStore (parallel/mesh.py::make_mesh): no default process group, no
extra interpreter, no environment variable.  Every thread is joined with a
timeout and a rank that raises fails the test.

* the placement trees against the JAX package's PartitionSpecs;
* shard/gather round trips on meshes (1,2), (2,1) and (2,2);
* the sharded step against the port's single-process slam_step, at
  tests/test_sharding.py's single-step tolerances (pose and T_odometry
  1e-4, conf 1e-4, static_prob 1e-3, surfel count exact), on 80x64 with
  capacity 1<<14 and test_sharding.py's twist, at F=1 on (1,2), (2,1) and
  (2,2) and at F=4 on (1,2) and (2,1); one 2-rank step against JAX's
  slam_step from the same state;
* a sharded bootstrap and 10 frames against the single-process run, at
  test_sharding.py's sequence tolerances (6e-3 per pose, 1% surfels,
  5e-4 ATE), and DistributedSlam over 4 frames;
* the division made visible: per-rank slot and pixel counts of every
  divided stage, and disjoint z-buffer winners across map ranks;
* each collective helper, its result and its counters;
* optimize_sharded on 2 and 4 ranks against the port's optimize and JAX's
  optimize_sharded, within 1e-5;
* DistributedSlam's default device, and a rank that raises.
"""

import os
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.fusion import predict as jpredict
from staticfusion_tpu.fusion import surfels as jsurfels
from staticfusion_tpu.geometry import se3 as jse3
from staticfusion_tpu.io import synthetic
from staticfusion_tpu.parallel import mesh as jmesh
from staticfusion_tpu.parallel import posegraph as jpg
from staticfusion_tpu.pipeline import state as jstate
from staticfusion_tpu.pipeline import step as jstep
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.io.trajectory import ate_rmse
from staticfusion_tpu_torch.parallel import mesh as tmesh
from staticfusion_tpu_torch.parallel import posegraph as tpg
from staticfusion_tpu_torch.parallel.distributed import DistributedSlam
from staticfusion_tpu_torch.parallel.sharded import (make_sharded_bootstrap,
                                                     make_sharded_step)
from staticfusion_tpu_torch.pipeline.state import state_to_numpy
from staticfusion_tpu_torch.pipeline.step import (Frame, bootstrap_step,
                                                  slam_step)

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=80, height=64),
                  fusion=FusionConfig(capacity=1 << 14))
CONFIGS = {1: TorchConfig.from_json(CONFIG.replace(fusion=FusionConfig(
               capacity=1 << 14, index_factor=1)).to_json()),
           4: TorchConfig.from_json(CONFIG.to_json())}
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
SEQ_FRAMES = 10
TIMEOUT = 60


class RankFailure(Exception):
    def __init__(self, errors):
        super().__init__(f"ranks failed: {errors}")
        self.errors = errors


def run_ranks(n_pix, n_map, fn, timeout=TIMEOUT):
    """fn(mesh) on every rank of an n_pix x n_map mesh, one thread each;
    {rank: result}.  Raises RankFailure if a rank raised, and fails the
    test if a rank is still running `timeout` + 30 s after the start."""
    store = dist.HashStore()
    results, errors = {}, {}
    env = dict(os.environ)

    def body(rank):
        try:
            mesh = tmesh.make_mesh(n_pix, n_map, rank, store,
                                   timedelta(seconds=timeout), device="cpu")
            results[rank] = fn(mesh)
        except Exception as e:  # reported below, with every rank's
            errors[rank] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(n_pix * n_map)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout + 30
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, t in enumerate(threads) if t.is_alive()]
    assert not hung, f"ranks {hung} still running after {timeout + 30} s"
    # The ranks leave nothing behind in this process.
    assert not dist.is_initialized()
    assert dict(os.environ) == env
    if errors:
        raise RankFailure(errors)
    return results


def torch_frame(frames, i):
    rgb, depth, _ = frames[i]
    return Frame(torch.as_tensor(rgb), torch.as_tensor(depth))


@pytest.fixture(scope="module")
def boot():
    """{F: (config, state after bootstrap, frame 2)} of the port, one
    process."""
    out = {}
    frames, _ = synthetic.make_sequence(CONFIG, 3, TWIST)
    for F, cfg in CONFIGS.items():
        state, _ = bootstrap_step(torch_frame(frames, 0),
                                  torch_frame(frames, 1), torch.eye(4), cfg)
        out[F] = (cfg, state, torch_frame(frames, 2))
    return out


def leaves(tree, prefix=""):
    """{dotted field name: leaf} of a tree of NamedTuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), prefix + f + "."))
        return out
    return {prefix[:-1]: tree}


def max_diff(a, b):
    return float((a.double() - b.double()).abs().max())


# -- placements -------------------------------------------------------------

@pytest.mark.parametrize("tree", ["surfel_map", "state", "frame"])
def test_placements_match_jax(tree):
    jm = jmesh.make_mesh(2, 4)
    want = leaves(getattr(jmesh, f"{tree}_shardings")(jm))
    got = leaves(getattr(tmesh, f"{tree}_shardings")())
    assert set(got) == set(want)
    for name, sh in want.items():
        assert got[name] == tuple(sh.spec), name


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_shard_gather_round_trip(boot, shape):
    cfg, state, frame = boot[1]
    n_pix, n_map = shape

    def fn(mesh):
        local = tmesh.place_state(state, mesh)
        lf = tmesh.shard_tree(frame, tmesh.frame_shardings(), mesh)
        lo, hi = mesh.rows(cfg.rows)
        assert local.smap.capacity == state.smap.capacity // n_map
        assert local.prev_filt_depth.shape[0] == hi - lo
        assert local.rings.depth.shape[1] == hi - lo
        assert lf.rgb.shape[0] == hi - lo
        return (tmesh.gather_tree(local, tmesh.state_shardings(), mesh,
                                  cfg.rows),
                tmesh.gather_tree(lf, tmesh.frame_shardings(), mesh,
                                  cfg.rows))

    for full, full_frame in run_ranks(n_pix, n_map, fn).values():
        for name, want in leaves(state).items():
            torch.testing.assert_close(leaves(full)[name], want, rtol=0,
                                       atol=0, equal_nan=True, msg=name)
        assert torch.equal(full_frame.rgb, frame.rgb)
        assert torch.equal(full_frame.depth_mm, frame.depth_mm)


# -- the sharded step -------------------------------------------------------

def sharded_step(cfg, state, frame, shape):
    def fn(mesh):
        local = tmesh.place_state(state, mesh)
        lf = tmesh.shard_tree(frame, tmesh.frame_shardings(), mesh)
        new, out = make_sharded_step(cfg, mesh)(local, lf)
        return (tmesh.gather_tree(new, tmesh.state_shardings(), mesh,
                                  cfg.rows), out, mesh)
    return run_ranks(*shape, fn)


@pytest.mark.parametrize("F,shape", [(1, (1, 2)), (1, (2, 1)), (1, (2, 2)),
                                     (4, (1, 2)), (4, (2, 1))])
def test_sharded_step_matches_single(boot, F, shape):
    cfg, state, frame = boot[F]
    ref_state, ref = slam_step(state, frame, cfg)
    for rank, (full, out, _) in sharded_step(cfg, state, frame,
                                             shape).items():
        assert max_diff(out.curr_pose, ref.curr_pose) < 1e-4, rank
        assert max_diff(out.T_odometry, ref.T_odometry) < 1e-4, rank
        assert int(out.surfel_count) == int(ref.surfel_count), rank
        assert max_diff(full.smap.conf, ref_state.smap.conf) < 1e-4, rank
        assert max_diff(out.static_prob, ref.static_prob) < 1e-3, rank
        assert int(full.smap.used) == int(ref_state.smap.used), rank


JAX_TYPES = {"smap": jsurfels.SurfelMap, "rings": jstate.RingBuffers,
             "pred": jpredict.PredictedView}


def to_jax(node, cls=jstate.SlamState):
    """A JAX SlamState from a tree of host arrays with its field names."""
    return cls(**{f: (to_jax(getattr(node, f), JAX_TYPES[f])
                      if f in JAX_TYPES else jnp.asarray(getattr(node, f)))
                  for f in cls._fields})


def test_two_rank_sharded_step_matches_jax(boot):
    """From the port's bootstrap state, carried to the JAX package with
    state_to_numpy, the port's sharded step on a (1, 2) mesh against JAX's
    slam_step."""
    cfg, state, frame = boot[4]
    jnew, jout = jstep.slam_step(
        to_jax(state_to_numpy(state)),
        jstep.Frame(rgb=jnp.asarray(frame.rgb.numpy()),
                    depth_mm=jnp.asarray(frame.depth_mm.numpy())), CONFIG)
    jax.clear_caches()
    for rank, (full, out, _) in sharded_step(cfg, state, frame,
                                             (1, 2)).items():
        np.testing.assert_allclose(out.curr_pose.numpy(),
                                   np.asarray(jout.curr_pose), atol=1e-4)
        np.testing.assert_allclose(out.T_odometry.numpy(),
                                   np.asarray(jout.T_odometry), atol=1e-4)
        nj, nt = int(jout.surfel_count), int(out.surfel_count)
        assert abs(nj - nt) <= 0.01 * nj, (rank, nj, nt)
        np.testing.assert_allclose(out.static_prob.numpy(),
                                   np.asarray(jout.static_prob), atol=1e-3)
        assert full.smap.capacity == jnew.smap.pos.shape[0]


def test_sharded_sequence_matches_single():
    """Sharded bootstrap and steady state on a (2, 2) mesh over 10 frames
    against the single-process run."""
    cfg = CONFIGS[4]
    frames, gt = synthetic.make_sequence(CONFIG, SEQ_FRAMES, TWIST)
    F = lambda i: torch_frame(frames, i)
    ref_state, out = bootstrap_step(F(0), F(1), torch.eye(4), cfg)
    ref_poses = [out.curr_pose.numpy()]
    for i in range(2, SEQ_FRAMES):
        ref_state, out = slam_step(ref_state, F(i), cfg)
        ref_poses.append(out.curr_pose.numpy())

    def fn(mesh):
        cut = lambda f: tmesh.shard_tree(f, tmesh.frame_shardings(), mesh)
        state, out = make_sharded_bootstrap(cfg, mesh)(cut(F(0)), cut(F(1)),
                                                       torch.eye(4))
        poses = [out.curr_pose.numpy()]
        step = make_sharded_step(cfg, mesh)
        for i in range(2, SEQ_FRAMES):
            state, out = step(state, cut(F(i)))
            poses.append(out.curr_pose.numpy())
        return poses, int(out.surfel_count)

    times = np.arange(1, SEQ_FRAMES) / 30.0
    ate_ref = ate_rmse(times, np.stack(ref_poses), times, gt[1:])
    n_ref = int(ref_state.smap.count())
    for rank, (poses, n) in run_ranks(2, 2, fn).items():
        for k, (a, b) in enumerate(zip(ref_poses, poses)):
            np.testing.assert_allclose(a, b, atol=6e-3,
                                       err_msg=f"rank {rank} frame {k}")
        assert abs(n - n_ref) <= 0.01 * n_ref, (rank, n, n_ref)
        ate = ate_rmse(times, np.stack(poses), times, gt[1:])
        assert abs(ate - ate_ref) < 5e-4, (rank, ate, ate_ref)


def test_distributed_slam_matches_single():
    """DistributedSlam (host-local bootstrap, then the state lifted to a
    (1, 2) mesh) over 4 frames against the single-process run."""
    cfg = CONFIGS[4]
    frames, _ = synthetic.make_sequence(CONFIG, 4, TWIST)
    state, out = bootstrap_step(torch_frame(frames, 0),
                                torch_frame(frames, 1), torch.eye(4), cfg)
    ref = [out.curr_pose.numpy()]
    for i in range(2, 4):
        state, out = slam_step(state, torch_frame(frames, i), cfg)
        ref.append(out.curr_pose.numpy())

    def fn(mesh):
        slam = DistributedSlam(cfg, 1, 2, mesh=mesh, device="cpu")
        for rgb, depth, _ in frames:
            slam.process(rgb, depth)
        return slam.poses, slam.state.smap.capacity

    for rank, (poses, cap) in run_ranks(1, 2, fn).items():
        assert cap == state.smap.capacity // 2
        np.testing.assert_allclose(np.stack(poses), np.stack(ref),
                                   atol=1e-4, err_msg=f"rank {rank}")


# -- the division, made visible ---------------------------------------------

SLOT_STAGES = {"project", "associate", "zbuffer", "insert"}
PIXEL_STAGES = {"jacobian", "temporal", "segm"}


def test_work_divides_over_both_axes(boot):
    """On a (2, 2) mesh every per-surfel pass of a rank covers exactly its
    capacity / n_map slots and every per-pixel stage exactly its row
    block, at every solver level."""
    cfg, state, frame = boot[4]
    res = sharded_step(cfg, state, frame, (2, 2))
    cap = state.smap.capacity
    for rank, (_, _, mesh) in res.items():
        stages = {stage for stage, _ in mesh.work}
        assert SLOT_STAGES | PIXEL_STAGES <= stages, stages
        for (stage, extent), n in mesh.work.items():
            if stage in SLOT_STAGES:
                assert (extent, n) == (cap, cap // 2), (rank, stage)
            else:
                rows, cols = extent
                lo, hi = tmesh.block(rows, 2, mesh.pix)
                assert n == (hi - lo) * cols, (rank, stage, extent)
                assert n < rows * cols
    # The two pix rows of ranks hold complementary row blocks.
    assert (res[0][2].rows(cfg.rows)[1] == res[2][2].rows(cfg.rows)[0])


def test_zbuffer_winners_are_disjoint_across_map_ranks(boot):
    """Each map rank's z-buffer winners are surfels of its own slot block,
    no texel is won on two ranks, and together they are the
    single-process winners."""
    from staticfusion_tpu_torch.fusion.sparse import zbuffer_winners
    from staticfusion_tpu_torch.fusion.texelmap import project_surfels

    cfg, state, _ = boot[4]
    pose, tick = state.curr_pose, state.tick
    cam, F = cfg.camera, cfg.fusion.index_factor
    texel = lambda local: local.v4 * (cam.width * F) + local.u4

    local = project_surfels(state.smap, pose, cfg)
    _, won = zbuffer_winners(state.smap, local, tick, cfg)
    want = dict(zip(texel(local)[won].tolist(),
                    torch.nonzero(won)[:, 0].tolist()))

    def fn(mesh):
        smap = tmesh.place_state(state, mesh).smap
        loc = project_surfels(smap, pose, cfg, mesh)
        _, w = zbuffer_winners(smap, loc, tick, cfg, mesh)
        lo = mesh.slots(state.smap.capacity)[0]
        return dict(zip(texel(loc)[w].tolist(),
                        (lo + torch.nonzero(w)[:, 0]).tolist()))

    res = run_ranks(1, 2, fn)
    assert res[0] and res[1]
    assert not set(res[0]) & set(res[1])
    assert {**res[0], **res[1]} == want
    half = state.smap.capacity // 2
    assert all(i < half for i in res[0].values())
    assert all(i >= half for i in res[1].values())


@pytest.mark.parametrize("ib", [15, 23])
def test_zbuffer_over_map_matches_single(ib):
    """texelmap.zbuffer on two slot blocks, combined over `map`, against
    one process: the packed-key z-buffer (15 id bits) and the exact
    two-pass one (23), with depth ties that the smaller id must win."""
    from staticfusion_tpu_torch.fusion.texelmap import zbuffer

    rng = np.random.default_rng(3)
    N, S = 4096, 700
    target = torch.as_tensor(rng.integers(0, S + 1, N))   # S: no slot
    values = torch.as_tensor(np.round(rng.uniform(0.5, 4.0, N), 2),
                             dtype=torch.float32)          # many ties
    buf, key, winner = zbuffer(target, values, 4.5, ib, S)

    def fn(mesh):
        lo, hi = mesh.slots(N)
        b, k, w = zbuffer(target[lo:hi], values[lo:hi], 4.5, ib, S, lo,
                          mesh)
        return b, k, w, target[lo:hi][b[target[lo:hi]] == k]

    res = run_ranks(1, 2, fn)
    for rank, (b, k, w, _) in res.items():
        assert torch.equal(b, buf) and torch.equal(w, winner), rank
        lo, hi = tmesh.block(N, 2, rank)
        assert torch.equal(k, key[lo:hi]), rank
    won = [set(res[r][3].tolist()) - {S} for r in (0, 1)]
    assert not won[0] & won[1]
    assert won[0] | won[1] == set(target[buf[target] == key].tolist()) - {S}


# -- the collective helpers -------------------------------------------------

@pytest.mark.parametrize("helper", ["sum", "min", "max", "gather"])
def test_collective_helper(helper):
    """On a (2, 2) mesh, over each axis: the result, and the helper's call
    and byte counters."""
    def fn(mesh):
        out = {}
        for axis in ("pix", "map", "world"):
            r = mesh.axis_index(axis)
            if helper == "gather":
                n = 5   # uneven blocks: 2 rows and 3 rows
                lo, hi = tmesh.block(n, 2 if axis != "world" else 4, r)
                x = torch.arange(lo * 3, hi * 3, dtype=torch.float32
                                 ).reshape(hi - lo, 3)
                out[axis] = mesh.all_gather(x, axis, n)
            else:
                x = torch.tensor([10 * r + 1, 7 - r], dtype=torch.int64)
                out[axis] = mesh.all_reduce(x, helper, axis)
                assert torch.equal(x, torch.tensor([10 * r + 1, 7 - r]))
        return out, mesh.comm, mesh

    for rank, (out, comm, mesh) in run_ranks(2, 2, fn).items():
        for axis, got in out.items():
            k = mesh.axis_size(axis)
            if helper == "gather":
                want = torch.arange(15, dtype=torch.float32).reshape(5, 3)
            else:
                vals = torch.tensor([[10 * r + 1, 7 - r] for r in range(k)])
                want = {"sum": vals.sum(0), "min": vals.min(0).values,
                        "max": vals.max(0).values}[helper]
            assert torch.equal(got, want), (rank, axis)
        name = "all_gather" if helper == "gather" else f"all_reduce_{helper}"
        assert set(comm) == {name}
        assert comm[name][0] == 3
        if helper != "gather":
            assert comm[name][1] == 3 * 16


# -- optimize_sharded -------------------------------------------------------

def noisy_chain(seed=0, n=8):
    """tests/test_posegraph.py's sharded case: an 8-pose chain perturbed
    off the truth, its constraints padded to 16."""
    rng = np.random.default_rng(seed)
    exp = lambda x: np.asarray(jse3.se3_exp(jnp.asarray(x, jnp.float32)))
    gt = [np.eye(4, dtype=np.float32)]
    odom = []
    for _ in range(n - 1):
        T = exp(0.05 * rng.normal(size=6))
        odom.append(T)
        gt.append((gt[-1] @ T).astype(np.float32))
    noisy = [gt[0]] + [p @ exp(0.02 * rng.normal(size=6)) for p in gt[1:]]
    return jpg.chain_odometry_graph(noisy, odom, max_constraints=16)


def to_torch(g):
    return tpg.PoseGraph(
        poses=torch.as_tensor(np.array(g.poses)),
        n_poses=torch.as_tensor(np.array(g.n_poses)),
        ci=torch.as_tensor(np.array(g.ci, np.int64)),
        cj=torch.as_tensor(np.array(g.cj, np.int64)),
        cT=torch.as_tensor(np.array(g.cT)),
        cw=torch.as_tensor(np.array(g.cw)),
        n_constraints=torch.as_tensor(np.array(g.n_constraints)))


@pytest.mark.parametrize("n", [2, 4])
def test_optimize_sharded_matches_dense_and_jax(n):
    jg = noisy_chain()
    g = to_torch(jg)
    dense = tpg.optimize(g, iters=8).poses
    jm = JaxMesh(np.asarray(jax.devices()[:n]), axis_names=("pg",))
    want = np.asarray(jpg.optimize_sharded(jg, jm, axis="pg", iters=8).poses)
    jax.clear_caches()

    def fn(mesh):
        return tpg.optimize_sharded(g, mesh, iters=8).poses, mesh.work

    for rank, (poses, work) in run_ranks(1, n, fn).items():
        np.testing.assert_allclose(poses.numpy(), dense.numpy(), atol=1e-5)
        np.testing.assert_allclose(poses.numpy(), want, atol=1e-5)
        assert work[("constraints", 16)] == 16 // n


# -- entry points and failures ---------------------------------------------

def test_distributed_slam_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DistributedSlam(CONFIGS[4], 1, 2)


def test_rank_that_raises_fails_within_the_timeout():
    """Rank 1 raises before the collective; rank 0's all-reduce ends at the
    groups' timeout, and the test fails instead of hanging."""
    def fn(mesh):
        if mesh.rank == 1:
            raise ValueError("rank 1 failed")
        return mesh.all_reduce(torch.ones(2), "sum", "map")

    t0 = time.monotonic()
    with pytest.raises(RankFailure) as info:
        run_ranks(1, 2, fn, timeout=1)
    assert time.monotonic() - t0 < 30
    errors = info.value.errors
    assert isinstance(errors[1], ValueError)
    assert isinstance(errors[0], RuntimeError)
