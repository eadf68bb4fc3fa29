"""The port's plain kernel versions (K1 bilateral and the depth
preprocessing around it, K2 small SPD solves, K3 coupled IRLS loop and the
motion filter after it) against the JAX package on the same numpy inputs:
the XLA formulations, and the Pallas kernels in interpret mode, at the
shapes and tolerances of tests/test_pallas_kernels.py.  The CUDA kernels
themselves run only on the card (chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from staticfusion_tpu.kernels import bilateral_pallas, smallsolve_pallas
from staticfusion_tpu.ops import bilateral as jax_bilateral
from staticfusion_tpu_torch.ops import bilateral as pt_bilateral
from staticfusion_tpu_torch.ops import smallsolve as pt_smallsolve

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)


def _depth_image(rng, rows, cols):
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    d = 1500.0 + 900.0 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
    d += rng.normal(0.0, 30.0, (rows, cols)).astype(np.float32)
    d[rng.random((rows, cols)) < 0.1] = 0.0
    d[rng.random((rows, cols)) < 0.03] = 150.0
    d[rng.random((rows, cols)) < 0.03] = 6000.0
    return np.round(d).astype(np.float32)


def _bilateral_gate(got, want, d):
    assert np.all(np.abs(got - want) <= 1.0)
    assert np.mean(got != want) < 1e-3
    assert np.all(got[(d < 300.0) | (d > 4500.0)] == 0.0)


@pytest.mark.parametrize("rows,cols", [(24, 64), (16, 384), (40, 320),
                                       (48, 640)])
def test_bilateral_plain_matches_jax(rows, cols):
    """Same gate as the Pallas pin: <= 1 mm everywhere, < 1e-3 of pixels
    different, out-of-range centres exactly 0 — against both the XLA path
    and the Pallas kernel in interpret mode."""
    d = _depth_image(np.random.default_rng(rows * 1000 + cols), rows, cols)
    got = pt_bilateral.bilateral_filter_mm(torch.as_tensor(d), 4.5).numpy()
    _bilateral_gate(got, np.asarray(jax_bilateral.bilateral_filter_mm(
        jnp.asarray(d), 4.5)), d)
    _bilateral_gate(got, np.asarray(bilateral_pallas.bilateral_filter_mm(
        jnp.asarray(d), 4.5, interpret=True)), d)


def test_metricise_matches_jax():
    d = _depth_image(np.random.default_rng(3), 24, 32)
    np.testing.assert_array_equal(
        pt_bilateral.metricise_depth_mm(torch.as_tensor(d), 4.5).numpy(),
        np.asarray(jax_bilateral.metricise_depth_mm(jnp.asarray(d), 4.5)))


def _spd(rng, n, scale=1.0):
    a = rng.normal(size=(n, n)).astype(np.float32) * scale
    return a @ a.T + n * scale * scale * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [6, 24])
@pytest.mark.parametrize("nrhs", [None, 6])
def test_spd_solve_plain(n, nrhs):
    rng = np.random.default_rng(n * 10 + (nrhs or 0))
    M = _spd(rng, n)
    b = rng.normal(size=(n,) if nrhs is None else (n, nrhs)).astype(
        np.float32)
    got = pt_smallsolve.spd_solve_fast(torch.as_tensor(M),
                                       torch.as_tensor(b)).numpy()
    want = np.linalg.solve(M.astype(np.float64), b.astype(np.float64))
    kernel = np.asarray(smallsolve_pallas.spd_solve(
        jnp.asarray(M), jnp.asarray(b), interpret=True))
    scale = np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() / scale < 5e-5
    assert np.abs(got - kernel).max() / scale < 5e-5


def test_spd_solve_plain_ridge_and_inverse():
    rng = np.random.default_rng(7)
    M = _spd(rng, 6) - 5 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    got = pt_smallsolve.spd_solve(torch.as_tensor(M), torch.as_tensor(b),
                                  ridge=0.25).numpy()
    want = np.linalg.solve(M.astype(np.float64) + 0.25 * np.eye(6), b)
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-6) < 5e-5
    for n in (6, 24):
        M = _spd(np.random.default_rng(n), n)
        inv = pt_smallsolve.spd_inverse_fast(torch.as_tensor(M)).numpy()
        assert np.abs(inv @ M - np.eye(n)).max() < 1e-3
        np.testing.assert_allclose(
            inv, np.asarray(smallsolve_pallas.spd_inverse(
                jnp.asarray(M), interpret=True)), rtol=1e-4, atol=1e-6)


def test_spd_solve_plain_randomized():
    shape_rng = np.random.default_rng(7)
    for _ in range(8):
        n = int(shape_rng.integers(2, 33))
        scale = float(shape_rng.choice([1e-2, 1.0, 1e2]))
        rng = np.random.default_rng(n * 131 + int(scale))
        spd = _spd(rng, n, scale)
        b = rng.normal(size=(n,)).astype(np.float32)
        got = pt_smallsolve.spd_solve(torch.as_tensor(spd),
                                      torch.as_tensor(b)).numpy()
        want = np.linalg.solve(spd.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * scale)


# --- K3: the coupled IRLS loop ---------------------------------------------

def _random_system(rng, n):
    """Numpy inputs of a random IRLS system (plausible magnitudes), the
    generator of tests/test_pallas_kernels.py::_random_system."""
    k = 24
    labels = rng.integers(0, k + 1, n)
    valid = labels < k
    arrays = dict(
        labels=labels,
        A_cT=(0.5 * rng.standard_normal((6, n)) * valid).astype(np.float32),
        A_dT=(0.5 * rng.standard_normal((6, n)) * valid).astype(np.float32),
        B_c=(0.05 * rng.standard_normal(n) * valid).astype(np.float32),
        B_d=(0.05 * rng.standard_normal(n) * valid).astype(np.float32),
        b_prior=rng.uniform(-1, 2, k).astype(np.float32),
        lambda_t_w=rng.uniform(0, 1, k).astype(np.float32))
    conn = rng.random((k, k)) < 0.2
    arrays["conn"] = conn | conn.T
    return arrays


def _jax_system(a):
    from staticfusion_tpu.config import SFConfig
    from staticfusion_tpu.solver.irls import JacobianSystem, cluster_onehot
    from staticfusion_tpu.solver.segmentation import (SegPrior,
                                                      reg_normal_matrix)
    onehot = cluster_onehot(jnp.asarray(a["labels"]))
    sys = JacobianSystem(
        A_cT=jnp.asarray(a["A_cT"]), B_c=jnp.asarray(a["B_c"]),
        A_dT=jnp.asarray(a["A_dT"]), B_d=jnp.asarray(a["B_d"]),
        labels=jnp.asarray(a["labels"], jnp.int32), onehot=onehot,
        cluster_counts=jnp.sum(onehot[:, :24], axis=0),
        valid_count=jnp.asarray(float((a["labels"] < 24).sum())))
    prior = SegPrior(b_prior=jnp.asarray(a["b_prior"]),
                     lambda_t_w=jnp.asarray(a["lambda_t_w"]))
    cfg = SFConfig()
    return sys, prior, reg_normal_matrix(jnp.asarray(a["conn"]),
                                         cfg.solver.lambda_reg), cfg


def _torch_system(a):
    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.solver.irls import (JacobianSystem,
                                                    cluster_onehot)
    from staticfusion_tpu_torch.solver.segmentation import (
        SegPrior, reg_normal_matrix)
    lbl = torch.as_tensor(a["labels"])
    onehot = cluster_onehot(lbl)
    sys = JacobianSystem(
        A_cT=torch.as_tensor(a["A_cT"]), B_c=torch.as_tensor(a["B_c"]),
        A_dT=torch.as_tensor(a["A_dT"]), B_d=torch.as_tensor(a["B_d"]),
        labels=lbl.to(torch.int32), onehot=onehot,
        cluster_counts=torch.sum(onehot[:, :24], dim=0),
        valid_count=torch.tensor(float((a["labels"] < 24).sum())))
    prior = SegPrior(b_prior=torch.as_tensor(a["b_prior"]),
                     lambda_t_w=torch.as_tensor(a["lambda_t_w"]))
    cfg = SFConfig()
    return sys, prior, reg_normal_matrix(torch.as_tensor(a["conn"]),
                                         cfg.solver.lambda_reg), cfg


def _assert_irls_close(got, want):
    np.testing.assert_allclose(got.twist.numpy(), np.asarray(want.twist),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(got.b_segm.numpy(), np.asarray(want.b_segm),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.aver_res.numpy(),
                               np.asarray(want.aver_res), rtol=1e-5)
    np.testing.assert_allclose(got.est_cov.numpy(), np.asarray(want.est_cov),
                               rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("n,max_tile", [(700, None), (1500, 256)])
def test_irls_plain_matches_jax(n, max_tile, monkeypatch):
    """The port's plain loop against the JAX XLA loop and the fused Pallas
    kernel in interpret mode (max_tile=256: the multi-tile accumulation)."""
    from staticfusion_tpu.kernels import irls_pallas
    from staticfusion_tpu.solver.irls import solve_irls_xla as jax_irls
    from staticfusion_tpu_torch.solver.irls import solve_irls

    if max_tile is not None:
        monkeypatch.setattr(irls_pallas, "_MAX_TILE", max_tile)
    rng = np.random.default_rng(n)
    a = _random_system(rng, n)
    b0 = rng.uniform(0, 1, 24).astype(np.float32)
    jsys, jprior, jreg, jcfg = _jax_system(a)
    tsys, tprior, treg, tcfg = _torch_system(a)

    got = solve_irls(tsys, torch.as_tensor(b0), tprior, treg, tcfg)
    _assert_irls_close(got, jax_irls(jsys, jnp.asarray(b0), jprior, jreg,
                                     jcfg))
    _assert_irls_close(got, irls_pallas.solve_irls_fused(
        jsys, jnp.asarray(b0), jprior, jreg, jcfg, interpret=True))


def test_irls_plain_device_scalar_kb():
    """kb arrives as a device scalar (1.05 warm-up, 1.5 steady)."""
    from staticfusion_tpu.kernels import irls_pallas
    from staticfusion_tpu.solver.irls import solve_irls_xla as jax_irls
    from staticfusion_tpu_torch.solver.irls import solve_irls_xla

    rng = np.random.default_rng(9)
    a = _random_system(rng, 600)
    jsys, jprior, jreg, jcfg = _jax_system(a)
    tsys, tprior, treg, tcfg = _torch_system(a)
    b0 = np.full(24, 0.5, np.float32)
    fused = jax.jit(lambda kb: irls_pallas.solve_irls_fused(
        jsys, jnp.asarray(b0), jprior, jreg, jcfg, kb=kb, interpret=True))
    for kb in (1.05, 1.5):
        got = solve_irls_xla(tsys, torch.as_tensor(b0), tprior, treg, tcfg,
                             kb=torch.tensor(kb))
        _assert_irls_close(got, jax_irls(jsys, jnp.asarray(b0), jprior,
                                         jreg, jcfg, kb=jnp.asarray(kb)))
        want = fused(jnp.asarray(kb))
        np.testing.assert_allclose(got.twist.numpy(), np.asarray(want.twist),
                                   rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(got.b_segm.numpy(),
                                   np.asarray(want.b_segm), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("n,tiles", [(300, 1), (1200, 1), (4800, 3),
                                     (19200, 10), (76800, 38),
                                     (307200, 150)])
def test_irls_launch_plan(n, tiles):
    """K3's launch plan at the five QVGA level sizes and VGA level 0: one
    tile per 2048 pixels, the grid capped at the co-resident blocks, and
    scratch for every tile's partials (2 + 27 + 25 floats)."""
    from staticfusion_tpu_torch.kernels.irls import launch_plan

    assert launch_plan(n, 264) == (tiles, tiles, tiles * 54)
    assert launch_plan(n, 16) == (tiles, min(tiles, 16), tiles * 54)
    with pytest.raises(ValueError):
        launch_plan(n, 0)


def test_kernel_interfaces_match_the_sources():
    """What cannot be compiled here is read: every extern "C" function of
    csrc/*.cu has the ctypes signature the loader declares (pointers and
    streams as c_void_p), and K3's output offsets in the wrapper are the
    kernel's."""
    import ctypes
    import re

    from staticfusion_tpu_torch.kernels import _build
    from staticfusion_tpu_torch.kernels import irls as k3

    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        for name, params in re.findall(r"^int (sf_\w+)\(([^)]*)\)", text,
                                       re.M):
            found[name] = [ctypes.c_void_p if "*" in p or "Stream" in p
                           else kinds[p.split()[0]]
                           for p in params.split(",")]
        if src.name == "irls.cu":
            offsets = dict(re.findall(r"constexpr int (OUT_\w+) = (\d+);",
                                      text))
    assert found == _build._SIGNATURES
    assert {k: int(v) for k, v in offsets.items()} == {
        k: getattr(k3, k) for k in offsets}
    # twist 6, b_segm 24, aver_res, res_sq, est_cov 36, iterations, the
    # motion-filtered twist 6.
    assert k3.OUT_SIZE == k3.OUT_COV + 36 + 1 + 6 == k3.OUT_ITERS + 1 + 6 \
        == k3.OUT_FILT + 6 == 75


def test_cpu_tensors_take_the_plain_versions():
    """Dispatch: CPU tensors never reach the CUDA wrappers (whose launch
    counters stay untouched)."""
    from staticfusion_tpu_torch.kernels.bilateral import \
        bilateral_filter_mm_cuda
    from staticfusion_tpu_torch.kernels.irls import solve_irls_cuda
    from staticfusion_tpu_torch.kernels.smallsolve import spd_solve_cuda
    from staticfusion_tpu_torch.solver.irls import solve_irls, solve_irls_xla

    counters = (bilateral_filter_mm_cuda, spd_solve_cuda, solve_irls_cuda)
    before = [fn.launches for fn in counters]
    d = torch.as_tensor(_depth_image(np.random.default_rng(5), 16, 24))
    assert torch.equal(pt_bilateral.bilateral_filter_mm(d, 4.5),
                       pt_bilateral.bilateral_filter_mm_plain(d, 4.5))
    M = torch.as_tensor(_spd(np.random.default_rng(5), 6))
    b = torch.ones(6)
    assert torch.equal(pt_smallsolve.spd_solve_fast(M, b),
                       pt_smallsolve.spd_solve(M, b))
    sys, prior, reg, cfg = _torch_system(
        _random_system(np.random.default_rng(5), 300))
    b0 = torch.full((24,), 0.5)
    for got, want in zip(solve_irls(sys, b0, prior, reg, cfg),
                         solve_irls_xla(sys, b0, prior, reg, cfg)):
        assert torch.equal(got, want)
    assert [fn.launches for fn in counters] == before


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is refused before
    any build or launch."""
    from staticfusion_tpu_torch.kernels.bilateral import \
        bilateral_filter_mm_cuda
    from staticfusion_tpu_torch.kernels.irls import solve_irls_cuda
    from staticfusion_tpu_torch.kernels.smallsolve import (spd_inverse_cuda,
                                                           spd_solve_cuda)
    with pytest.raises(ValueError, match="CUDA"):
        bilateral_filter_mm_cuda(torch.zeros(8, 8), 4.5)
    with pytest.raises(ValueError, match="CUDA"):
        spd_solve_cuda(torch.eye(6), torch.ones(6))
    with pytest.raises(ValueError, match="CUDA"):
        spd_inverse_cuda(torch.eye(6))
    sys, prior, reg, cfg = _torch_system(
        _random_system(np.random.default_rng(3), 300))
    for kb in (None, 1.5, torch.tensor(1.5)):
        with pytest.raises(ValueError, match="CUDA"):
            solve_irls_cuda(sys, torch.full((24,), 0.5), prior, reg, cfg,
                            kb=kb)


def test_other_devices_are_refused():
    """Only CUDA (kernel) and CPU (plain version) tensors are accepted."""
    d = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pt_bilateral.bilateral_filter_mm(d, 4.5)
    with pytest.raises(ValueError, match="unsupported device"):
        pt_smallsolve.spd_solve_fast(torch.empty((6, 6), device="meta"),
                                     torch.empty(6, device="meta"))


# --- The solver's call: K3 and the motion filter in one dispatch -----------

_JAX_FUSED = {}  # n -> the JAX fused loop (interpret mode) on _filter_case


def _filter_case(n):
    """Numpy inputs of one filtered solve: a random system, b_segm0, the
    previous frame's twist and the level's accumulated transform."""
    from staticfusion_tpu_torch.geometry import se3 as pt_se3

    rng = np.random.default_rng(n + 17)
    a = _random_system(rng, n)
    b0 = rng.uniform(0, 1, 24).astype(np.float32)
    twist_old = rng.normal(0.0, 0.01, 6).astype(np.float32)
    T_odo = pt_se3.se3_exp(torch.as_tensor(
        rng.normal(0.0, 0.01, 6).astype(np.float32))).numpy()
    return a, b0, twist_old, T_odo


def _solver_config(cfg, use_filter):
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, use_motion_filter=use_filter))


@pytest.mark.parametrize("use_filter", [True, False])
@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("n", [300, 1200])
def test_irls_filtered_plain_matches_jax(n, level, use_filter):
    """The solver's call on CPU tensors is the plain loop followed by the
    motion filter, bit for bit (the twist unfiltered with the filter off),
    and agrees with the JAX fused Pallas kernel in interpret mode followed
    by the JAX motion filter, at test_irls_plain_matches_jax's
    tolerances."""
    from staticfusion_tpu.geometry import se3 as jax_se3
    from staticfusion_tpu.kernels import irls_pallas
    from staticfusion_tpu.solver.irls import motion_filter as jax_filter
    from staticfusion_tpu_torch.geometry import se3 as pt_se3
    from staticfusion_tpu_torch.solver.irls import (motion_filter,
                                                    solve_irls_filtered,
                                                    solve_irls_xla)

    a, b0, twist_old, T_odo = _filter_case(n)
    tsys, tprior, treg, tcfg = _torch_system(a)
    tcfg = _solver_config(tcfg, use_filter)
    tb0, told, tT = map(torch.as_tensor, (b0, twist_old, T_odo))
    got, twist = solve_irls_filtered(tsys, tb0, tprior, treg, tcfg, told,
                                     tT, level)
    plain = solve_irls_xla(tsys, tb0, tprior, treg, tcfg)
    want_twist = (motion_filter(plain.twist, plain.est_cov, told,
                                pt_se3.se3_log(tT), level, tcfg)
                  if use_filter else plain.twist)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    assert torch.equal(twist, want_twist)

    if n not in _JAX_FUSED:
        jsys, jprior, jreg, jcfg = _jax_system(a)
        _JAX_FUSED[n] = irls_pallas.solve_irls_fused(
            jsys, jnp.asarray(b0), jprior, jreg, jcfg, interpret=True), jcfg
    fused, jcfg = _JAX_FUSED[n]
    _assert_irls_close(got, fused)
    jtwist = (jax_filter(fused.twist, fused.est_cov, jnp.asarray(twist_old),
                         jax_se3.se3_log(jnp.asarray(T_odo)), level, jcfg)
              if use_filter else fused.twist)
    np.testing.assert_allclose(twist.numpy(), np.asarray(jtwist), rtol=2e-4,
                               atol=2e-6)


# --- The frame's depth preprocessing: K1 and both metricise passes --------

@pytest.mark.parametrize("rows,cols", [(24, 64), (40, 320)])
def test_preprocess_plain_matches_jax(rows, cols):
    """The preprocessing call on a CPU tensor is the plain bilateral filter
    followed by the two metricise calls, bit for bit, and agrees with the
    JAX pair on the same depth: raw_m exactly, filt_m within the bilateral
    gate (read back in millimetres)."""
    d = _depth_image(np.random.default_rng(rows * 7 + cols), rows, cols)
    t = torch.as_tensor(d)
    raw_m, filt_m = pt_bilateral.preprocess_depth_mm(t, 4.5)
    filtered = pt_bilateral.bilateral_filter_mm_plain(t, 4.5)
    assert torch.equal(raw_m, pt_bilateral.metricise_depth_mm(t, 4.5))
    assert torch.equal(filt_m,
                       pt_bilateral.metricise_depth_mm(filtered, 4.5))

    jd = jnp.asarray(d)
    np.testing.assert_array_equal(
        raw_m.numpy(), np.asarray(jax_bilateral.metricise_depth_mm(jd, 4.5)))
    want = np.asarray(jax_bilateral.metricise_depth_mm(
        jax_bilateral.bilateral_filter_mm(jd, 4.5), 4.5))
    _bilateral_gate(np.rint(filt_m.numpy() * 1000.0),
                    np.rint(want * 1000.0), d)


def _all_counters():
    from staticfusion_tpu_torch.kernels.bilateral import (
        bilateral_filter_mm_cuda, preprocess_depth_cuda)
    from staticfusion_tpu_torch.kernels.irls import solve_irls_cuda
    from staticfusion_tpu_torch.kernels.smallsolve import (spd_inverse_cuda,
                                                           spd_solve_cuda)
    return (preprocess_depth_cuda, bilateral_filter_mm_cuda, solve_irls_cuda,
            spd_solve_cuda, spd_inverse_cuda)


def test_preprocess_and_filtered_solve_leave_the_counters_on_cpu():
    """The two new dispatch calls take the plain versions for CPU tensors:
    no launch counter moves."""
    from staticfusion_tpu_torch.solver.irls import solve_irls_filtered

    before = [fn.launches for fn in _all_counters()]
    d = torch.as_tensor(_depth_image(np.random.default_rng(6), 16, 24))
    pt_bilateral.preprocess_depth_mm(d, 4.5)
    a, b0, twist_old, T_odo = _filter_case(300)
    sys, prior, reg, cfg = _torch_system(a)
    for use_filter in (True, False):
        solve_irls_filtered(sys, torch.as_tensor(b0), prior, reg,
                            _solver_config(cfg, use_filter),
                            torch.as_tensor(twist_old),
                            torch.as_tensor(T_odo), 1)
    assert [fn.launches for fn in _all_counters()] == before


def test_new_cuda_wrappers_reject_cpu_tensors():
    """The preprocessing and filtered-solve wrappers never fall back: a CPU
    tensor is refused before any build or launch, and counts nothing; the
    dispatch calls refuse other devices."""
    from staticfusion_tpu_torch.kernels.bilateral import preprocess_depth_cuda
    from staticfusion_tpu_torch.kernels.irls import solve_irls_filtered_cuda

    before = [fn.launches for fn in _all_counters()]
    with pytest.raises(ValueError, match="CUDA"):
        preprocess_depth_cuda(torch.zeros(8, 8), 4.5)
    sys, prior, reg, cfg = _torch_system(
        _random_system(np.random.default_rng(4), 300))
    for acc in (torch.zeros(6), None):
        with pytest.raises(ValueError, match="CUDA"):
            solve_irls_filtered_cuda(sys, torch.full((24,), 0.5), prior, reg,
                                     cfg, torch.zeros(6), acc, 0)
    assert [fn.launches for fn in _all_counters()] == before
    with pytest.raises(ValueError, match="unsupported device"):
        pt_bilateral.preprocess_depth_mm(torch.empty((8, 8), device="meta"),
                                         4.5)


def test_preprocess_outputs_match_the_source():
    """The wrapper passes sf_preprocess's output pointers in the order the
    source declares them."""
    import re

    from staticfusion_tpu_torch.kernels import _build
    from staticfusion_tpu_torch.kernels import bilateral as k1

    text = (_build.CSRC / "bilateral.cu").read_text()
    params = re.search(r"^int sf_preprocess\(([^)]*)\)", text, re.M)
    names = [p.split()[-1].lstrip("*") for p in params.group(1).split(",")]
    assert tuple(names[1:4]) == k1._OUTPUTS
