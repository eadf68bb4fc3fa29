"""The port's pose-graph solver (parallel/posegraph.py::optimize_chain)
against the JAX package on the same graphs (CPU, float32).

Each graph is a drifted odometry chain of M poses in optimize_chain's
layout (slots [0, M-1) the chain k -> k+1) plus L loop constraints
measured from ground truth; at L = 3 two loops share their first pose and
two their last (none on the gauge-fixed pose 0), so the loop adds
accumulate onto repeated indices.  The port agrees with JAX's
optimize_chain within 1e-5 (measured: <= 6e-7) and with JAX's dense
Gauss-Newton (`optimize`, the oracle) within 2e-4, the tolerance of
tests/test_posegraph.py's own chain-vs-dense check; the first pose stays
fixed within 1e-6.  A graph that breaks the layout raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from staticfusion_tpu.geometry import se3 as jse3
from staticfusion_tpu.parallel import posegraph as jpg
from staticfusion_tpu_torch.parallel import posegraph as tpg

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CHAIN_TOL = 1e-5
ORACLE_TOL = 2e-4


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test."""
    yield
    jax.clear_caches()


def to_torch(g: jpg.PoseGraph) -> tpg.PoseGraph:
    return tpg.PoseGraph(
        poses=torch.as_tensor(np.array(g.poses)),
        n_poses=torch.as_tensor(np.array(g.n_poses)),
        ci=torch.as_tensor(np.array(g.ci, np.int64)),
        cj=torch.as_tensor(np.array(g.cj, np.int64)),
        cT=torch.as_tensor(np.array(g.cT)),
        cw=torch.as_tensor(np.array(g.cw)),
        n_constraints=torch.as_tensor(np.array(g.n_constraints)))


def _exp(x):
    return np.asarray(jse3.se3_exp(jnp.asarray(x, jnp.float32)))


def chain_graph(M, L, seed=0):
    """(JAX graph, ground truth): a chain with a constant odometry bias
    and L exact loop constraints (weight 8)."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    odom = []
    for _ in range(M - 1):
        x = rng.normal(size=6).astype(np.float32) * 0.05
        odom.append(_exp(x))
        gt.append(gt[-1] @ odom[-1])
    drift = _exp([0.008, -0.006, 0.01, 0.003, -0.002, 0.004])
    init = [gt[0]]
    for T in odom:
        init.append(init[-1] @ T @ drift)
    g = jpg.empty_graph(M, (M - 1) + L)
    g = g._replace(poses=jnp.asarray(np.stack(init)),
                   n_poses=jnp.asarray(M, jnp.int32))
    for k in range(M - 1):
        g = jpg.add_constraint(g, k, k + 1,
                               jnp.asarray(odom[k] @ drift), 1.0)
    loops = [(1, M - 1), (1, M // 2), (2, M - 1)][:L]
    for i, j in loops:
        g = jpg.add_constraint(g, i, j,
                               jnp.asarray(np.linalg.inv(gt[i]) @ gt[j]),
                               8.0)
    return g, np.stack(gt)


@pytest.mark.parametrize("L", [0, 1, 3])
@pytest.mark.parametrize("M", [8, 64])
def test_optimize_chain_matches_jax(M, L):
    g, gt = chain_graph(M, L, seed=M + L)
    want = np.asarray(jpg.optimize_chain(g, iters=10).poses)
    got = tpg.optimize_chain(to_torch(g), iters=10).poses.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_TOL)
    np.testing.assert_allclose(got[0], np.eye(4), rtol=0, atol=1e-6)
    if L:
        # The loops pull the drifted end back toward the truth.
        init = np.asarray(g.poses)
        assert (np.linalg.norm(got[-1, :3, 3] - gt[-1, :3, 3])
                < 0.5 * np.linalg.norm(init[-1, :3, 3] - gt[-1, :3, 3]))


@pytest.mark.parametrize("M", [8, 64])
def test_optimize_chain_matches_dense_oracle(M):
    g, _ = chain_graph(M, 3, seed=100 + M)
    want = np.asarray(jpg.optimize(g, iters=10).poses)
    got = tpg.optimize_chain(to_torch(g), iters=10).poses.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ORACLE_TOL)


@pytest.mark.parametrize("fault", ["swapped_chain_slots", "loop_in_chain",
                                   "too_few_slots"])
def test_layout_check_raises(fault):
    g, _ = chain_graph(8, 1)
    tg = to_torch(g)
    if fault == "swapped_chain_slots":
        perm = torch.arange(tg.ci.shape[0])
        perm[[2, 5]] = perm[[5, 2]]
        tg = tg._replace(ci=tg.ci[perm], cj=tg.cj[perm], cT=tg.cT[perm],
                         cw=tg.cw[perm])
        match = "slot 2"
    elif fault == "loop_in_chain":
        ci, cj = tg.ci.clone(), tg.cj.clone()
        ci[3], cj[3] = 0, 7
        tg = tg._replace(ci=ci, cj=cj)
        match = "slot 3 links poses 0 -> 7"
    else:
        tg = tg._replace(ci=tg.ci[:5], cj=tg.cj[:5], cT=tg.cT[:5],
                         cw=tg.cw[:5])
        match = "below the chain length"
    with pytest.raises(ValueError, match=match):
        tpg.optimize_chain(tg)


def test_add_constraint_and_adjoint_match_jax():
    rng = np.random.default_rng(7)
    T = _exp(rng.normal(size=6) * 0.3)
    jg = jpg.add_constraint(jpg.empty_graph(4, 5), 1, 3, jnp.asarray(T), 2.5)
    tg = tpg.add_constraint(tpg.empty_graph(4, 5), 1, 3, torch.tensor(T),
                            2.5)
    for f in jg._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)))
    Ts = np.stack([_exp(rng.normal(size=6) * 0.5) for _ in range(3)])
    np.testing.assert_allclose(tpg._adjoint(torch.as_tensor(Ts)).numpy(),
                               np.asarray(jpg._adjoint(jnp.asarray(Ts))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The dense solver (optimize, add_pose, chain_odometry_graph) against JAX's
# on tests/test_posegraph.py's graphs.  Float32 sums in another order:
# DENSE_TOL = 1e-5 against JAX's optimize (measured: <= 1.2e-7).

DENSE_TOL = 1e-5


def _truth(M, seed):
    """(ground truth (M, 4, 4), exact odometry list)."""
    rng = np.random.default_rng(seed)
    gt, odom = [np.eye(4, dtype=np.float32)], []
    for _ in range(M - 1):
        x = rng.normal(size=6).astype(np.float32) * 0.05
        odom.append(_exp(x))
        gt.append(gt[-1] @ odom[-1])
    return np.stack(gt), odom


def _both(init, odom, **kw):
    """The same odometry graph built by each package's
    chain_odometry_graph."""
    jg = jpg.chain_odometry_graph([jnp.asarray(p) for p in init],
                                  [jnp.asarray(T) for T in odom], **kw)
    tg = tpg.chain_odometry_graph(list(init), odom, **kw)
    return jg, tg


def test_chain_odometry_graph_and_add_pose_match_jax():
    gt, odom = _truth(5, 11)
    jg, tg = _both(list(gt), odom, weights=[1.0, 2.0, 0.5, 3.0],
                   max_poses=7, max_constraints=9)
    for f in jg._fields:
        np.testing.assert_allclose(np.asarray(getattr(tg, f)),
                                   np.asarray(getattr(jg, f)), rtol=0,
                                   atol=0)
    jg = jpg.add_pose(jg, jnp.asarray(gt[1]))
    tg = tpg.add_pose(tg, torch.as_tensor(gt[1]))
    assert int(tg.n_poses) == int(jg.n_poses) == 6
    np.testing.assert_array_equal(tg.poses.numpy(), np.asarray(jg.poses))


@pytest.mark.parametrize("case", ["exact", "noisy", "loop", "padded"])
def test_dense_optimize_matches_jax(case):
    """tests/test_posegraph.py's dense cases through both packages: an
    exact chain stays put, a perturbed chain converges to the truth, an
    exact loop constraint pulls back drift, and padding (zero-weight
    constraints, unused poses) stays identity."""
    M = {"exact": 6, "noisy": 8, "loop": 10, "padded": 4}[case]
    gt, odom = _truth(M, 20 + M)
    rng = np.random.default_rng(M)
    init, kw, iters = list(gt), {}, 5
    if case == "noisy":
        init = [gt[0]] + [p @ _exp(0.03 * rng.normal(size=6))
                          for p in gt[1:]]
        iters = 15
    elif case == "loop":
        drift = _exp([0.01, -0.008, 0.012, 0.004, -0.003, 0.005])
        odom = [T @ drift for T in odom]
        init = [gt[0]]
        for T in odom:
            init.append(init[-1] @ T)
        kw, iters = {"max_constraints": 2 * M}, 20
    elif case == "padded":
        kw = {"max_poses": 16, "max_constraints": 32}
    jg, tg = _both(init, odom, **kw)
    if case == "loop":
        T_0n = np.linalg.inv(gt[0]) @ gt[-1]
        jg = jpg.add_constraint(jg, 0, M - 1, jnp.asarray(T_0n), 10.0)
        tg = tpg.add_constraint(tg, 0, M - 1, torch.as_tensor(T_0n), 10.0)
    want = np.asarray(jpg.optimize(jg, iters=iters).poses)
    got = tpg.optimize(tg, iters=iters).poses.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DENSE_TOL)
    np.testing.assert_allclose(got[0], gt[0], rtol=0, atol=1e-6)
    if case in ("exact", "noisy"):
        np.testing.assert_allclose(got[:M], gt,
                                   atol=1e-5 if case == "exact" else 1e-3)
    elif case == "loop":
        before = np.linalg.norm(init[-1][:3, 3] - gt[-1][:3, 3])
        after = np.linalg.norm(got[-1, :3, 3] - gt[-1][:3, 3])
        assert after < 0.35 * before
    else:
        np.testing.assert_allclose(got[8:], np.broadcast_to(np.eye(4),
                                                            (8, 4, 4)),
                                   atol=1e-5)


def test_dense_optimize_accumulates_repeated_indices():
    """Constraints that repeat a pose pair, and several sharing one pose:
    every Hessian and gradient block must add up (plain indexed writes
    would keep one)."""
    gt, odom = _truth(6, 31)
    drift = _exp([0.006, 0.004, -0.008, 0.002, 0.003, -0.002])
    init = [gt[0]]
    for T in odom:
        init.append(init[-1] @ T @ drift)
    jg, tg = _both(init, [T @ drift for T in odom], max_constraints=12)
    for i, j, w in ((1, 4, 4.0), (1, 4, 2.0), (1, 5, 3.0), (2, 5, 5.0),
                    (2, 5, 1.0), (3, 5, 2.0)):
        T = np.linalg.inv(gt[i]) @ gt[j]
        jg = jpg.add_constraint(jg, i, j, jnp.asarray(T), w)
        tg = tpg.add_constraint(tg, i, j, torch.as_tensor(T), w)
    H, b = tpg._normal_equations(tg.poses, tg.ci, tg.cj, tg.cT, tg.cw)
    jH, jb = jpg._normal_equations(jg.poses, jg.ci, jg.cj, jg.cT, jg.cw)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-6)
    want = np.asarray(jpg.optimize(jg, iters=10).poses)
    got = tpg.optimize(tg, iters=10).poses.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DENSE_TOL)


@pytest.mark.parametrize("M", [8, 33])
def test_chain_solver_matches_the_ports_dense_solver(M):
    """optimize_chain against the port's own optimize (the oracle of
    tests/test_posegraph.py's chain-vs-dense property test)."""
    g, _ = chain_graph(M, 2, seed=200 + M)
    tg = to_torch(g)
    np.testing.assert_allclose(tpg.optimize_chain(tg, iters=10).poses,
                               tpg.optimize(tg, iters=10).poses, rtol=0,
                               atol=ORACLE_TOL)
