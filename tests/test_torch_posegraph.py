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
