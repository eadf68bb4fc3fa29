#!/usr/bin/env python3
"""Smoke test of the PyTorch port (staticfusion_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device: requires CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles staticfusion_tpu_torch/csrc/*.cu with nvcc;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     same inputs (plain version run on the CPU), with the stated
     tolerances; times of kernel and plain version on the card (CUDA
     events) at the main path's shapes;
  4. main path: SlamSystem(SFConfig(), device="cuda") over a 30-frame
     synthetic static QVGA sequence (seed 0): ATE, finiteness, surfel
     counts, per-kernel launch counts of that run, median ms/frame;
  5. card vs CPU: the first 6 frames through the port on the card and on
     the CPU, poses and surfel counts compared;
then a JSON line with the kernels, and last a JSON line
{"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

FRAMES = 30
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
ATE_LIMIT = 0.02        # metres; the healthy signal of the static sequence
CROSS_FRAMES = 6
# Card vs CPU: float sums differ in order between the two, which can flip
# one IRLS convergence test (a change of up to one IRLS step, ~1.5e-3).
POSE_TOL = 2e-3
COUNT_TOL = 0.01


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, reps, warmup=3):
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def depth_image(rng, rows, cols):
    """Depth-like mm image with holes and out-of-range values (the shape of
    tests/test_pallas_kernels.py::_depth_image)."""
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    d = 1500.0 + 900.0 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
    d += rng.normal(0.0, 30.0, (rows, cols)).astype(np.float32)
    d[rng.random((rows, cols)) < 0.1] = 0.0
    d[rng.random((rows, cols)) < 0.03] = 150.0
    d[rng.random((rows, cols)) < 0.03] = 6000.0
    return np.round(d).astype(np.float32)


def random_irls_system(rng, n, device):
    """A random JacobianSystem/prior/regulariser with plausible
    magnitudes (tests/test_pallas_kernels.py::_random_system)."""
    import torch

    from staticfusion_tpu_torch.config import NUM_CLUSTERS, SFConfig
    from staticfusion_tpu_torch.solver.irls import (JacobianSystem,
                                                    cluster_onehot)
    from staticfusion_tpu_torch.solver.segmentation import (SegPrior,
                                                            reg_normal_matrix)
    k = NUM_CLUSTERS
    labels = rng.integers(0, k + 1, n)
    valid = labels < k
    A_cT = (0.5 * rng.standard_normal((6, n)) * valid).astype(np.float32)
    A_dT = (0.5 * rng.standard_normal((6, n)) * valid).astype(np.float32)
    B_c = (0.05 * rng.standard_normal(n) * valid).astype(np.float32)
    B_d = (0.05 * rng.standard_normal(n) * valid).astype(np.float32)
    b_prior = rng.uniform(-1, 2, k).astype(np.float32)
    lam = rng.uniform(0, 1, k).astype(np.float32)
    conn = rng.random((k, k)) < 0.2
    conn = conn | conn.T
    b0 = rng.uniform(0, 1, k).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    lbl = t(labels.astype(np.int64))
    onehot = cluster_onehot(lbl)
    sys_ = JacobianSystem(
        A_cT=t(A_cT), B_c=t(B_c), A_dT=t(A_dT), B_d=t(B_d),
        labels=lbl.to(torch.int32), onehot=onehot,
        cluster_counts=torch.sum(onehot[:, :k], dim=0),
        valid_count=t(np.float32(valid.sum())))
    cfg = SFConfig()
    prior = SegPrior(b_prior=t(b_prior), lambda_t_w=t(lam))
    reg = reg_normal_matrix(t(conn), cfg.solver.lambda_reg)
    return sys_, t(b0), prior, reg, cfg


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: "
          "this smoke test needs an NVIDIA GPU and does not fall back to "
          "the CPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build():
    from staticfusion_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"[build] {time.perf_counter() - t0:.1f} s (nvcc, sm_90a) -> "
          f"{os.path.relpath(lib._name)}", flush=True)


def phase_k1(rows_list=((240, 320), (480, 640))):
    import torch

    from staticfusion_tpu_torch.kernels.bilateral import (
        bilateral_filter_mm_cuda, bilateral_filter_mm_plain)
    worst = 0.0
    for rows, cols in rows_list:
        d = depth_image(np.random.default_rng(rows * 1000 + cols), rows,
                        cols)
        got = bilateral_filter_mm_cuda(torch.as_tensor(d, device="cuda"),
                                       4.5).cpu().numpy()
        want = bilateral_filter_mm_plain(torch.as_tensor(d), 4.5).numpy()
        err = float(np.abs(got - want).max())
        frac = float(np.mean(got != want))
        check(err <= 1.0, f"K1 {rows}x{cols}: max |diff| {err} mm > 1")
        check(frac < 1e-3, f"K1 {rows}x{cols}: {frac} of pixels differ")
        check(np.all(got[(d < 300.0) | (d > 4500.0)] == 0.0),
              f"K1 {rows}x{cols}: out-of-range centre not zero")
        worst = max(worst, err)
    d = torch.as_tensor(depth_image(np.random.default_rng(1), 240, 320),
                        device="cuda")
    ms = cuda_ms(lambda: bilateral_filter_mm_cuda(d, 4.5), 200)
    plain_ms = cuda_ms(lambda: bilateral_filter_mm_plain(d, 4.5), 10)
    print(f"[K1 bilateral] ok: 240x320 and 480x640 within 1 mm, <1e-3 "
          f"pixels differ; 240x320 {ms:.4f} ms vs plain {plain_ms:.4f} ms",
          flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_k2():
    import torch

    from staticfusion_tpu_torch.kernels.smallsolve import (spd_inverse,
                                                           spd_inverse_cuda,
                                                           spd_solve,
                                                           spd_solve_cuda)
    cases = [(6, 1.0, 6), (24, 1.0, 24)]
    srng = np.random.default_rng(7)
    for _ in range(8):
        cases.append((int(srng.integers(2, 33)),
                      float(srng.choice([1e-2, 1.0, 1e2])),
                      int(srng.integers(0, 1000))))
    err_solve = err_inv = 0.0
    for n, scale, seed in cases:
        rng = np.random.default_rng(n * 131 + seed)
        a = rng.normal(size=(n, n)).astype(np.float32) * scale
        spd = a @ a.T + n * scale * scale * np.eye(n, dtype=np.float32)
        b = rng.normal(size=(n,)).astype(np.float32)
        Mc = torch.as_tensor(spd, device="cuda")
        got = spd_solve_cuda(Mc, torch.as_tensor(b, device="cuda")).cpu()
        want64 = np.linalg.solve(spd.astype(np.float64),
                                 b.astype(np.float64))
        np.testing.assert_allclose(got.numpy(), want64, rtol=2e-3,
                                   atol=2e-3 * scale,
                                   err_msg=f"K2 solve n={n} scale={scale}")
        plain = spd_solve(torch.as_tensor(spd), torch.as_tensor(b))
        err_solve = max(err_solve, float((got - plain).abs().max()))
        inv = spd_inverse_cuda(Mc).cpu()
        inv64 = np.linalg.inv(spd.astype(np.float64))
        np.testing.assert_allclose(inv.numpy(), inv64, rtol=2e-3,
                                   atol=2e-3 * np.abs(inv64).max(),
                                   err_msg=f"K2 inverse n={n}")
        err_inv = max(err_inv, float((inv - spd_inverse(
            torch.as_tensor(spd))).abs().max()))
    rng = np.random.default_rng(6)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    M6 = torch.as_tensor(a @ a.T + 6 * np.eye(6, dtype=np.float32),
                         device="cuda")
    b6 = torch.as_tensor(rng.normal(size=6).astype(np.float32),
                         device="cuda")
    t = {"solve": cuda_ms(lambda: spd_solve_cuda(M6, b6), 500),
         "solve_plain": cuda_ms(lambda: spd_solve(M6, b6), 20),
         "inv": cuda_ms(lambda: spd_inverse_cuda(M6, 1e-12), 500),
         "inv_plain": cuda_ms(lambda: spd_inverse(M6, 1e-12), 20)}
    print(f"[K2 smallsolve] ok: n in {{6, 24}} + 8 random n 2..32 at scales "
          f"1e-2..1e2 within rtol 2e-3 of float64; 6x6 solve "
          f"{t['solve']:.4f} ms vs plain {t['solve_plain']:.4f} ms, 6x6 "
          f"inverse {t['inv']:.4f} ms vs plain {t['inv_plain']:.4f} ms",
          flush=True)
    return ({"max_abs_err": err_solve, "ms": t["solve"],
             "plain_ms": t["solve_plain"]},
            {"max_abs_err": err_inv, "ms": t["inv"],
             "plain_ms": t["inv_plain"]})


def phase_k3():
    import torch

    from staticfusion_tpu_torch.kernels.irls import (solve_irls_cuda,
                                                     solve_irls_xla)
    worst = 0.0
    for n in (76800, 1500):
        for kb in (1.05, 1.5):
            rng = np.random.default_rng(n)
            sys_g, b0_g, prior_g, reg_g, cfg = random_irls_system(rng, n,
                                                                  "cuda")
            rng = np.random.default_rng(n)
            sys_c, b0_c, prior_c, reg_c, _ = random_irls_system(rng, n,
                                                                "cpu")
            got = solve_irls_cuda(sys_g, b0_g, prior_g, reg_g, cfg,
                                  kb=torch.tensor(kb, device="cuda"))
            want = solve_irls_xla(sys_c, b0_c, prior_c, reg_c, cfg,
                                  kb=torch.tensor(kb))
            g = {f: getattr(got, f).cpu().numpy() for f in got._fields}
            w = {f: getattr(want, f).numpy() for f in want._fields}
            tag = f"K3 n={n} kb={kb}"
            np.testing.assert_allclose(g["twist"], w["twist"], rtol=2e-4,
                                       atol=2e-6, err_msg=tag + " twist")
            np.testing.assert_allclose(g["b_segm"], w["b_segm"], rtol=2e-4,
                                       atol=2e-5, err_msg=tag + " b_segm")
            np.testing.assert_allclose(g["aver_res"], w["aver_res"],
                                       rtol=1e-4, err_msg=tag + " aver_res")
            np.testing.assert_allclose(g["est_cov"], w["est_cov"], rtol=2e-3,
                                       atol=1e-6, err_msg=tag + " est_cov")
            worst = max(worst, float(np.abs(g["twist"] - w["twist"]).max()),
                        float(np.abs(g["b_segm"] - w["b_segm"]).max()))
    rng = np.random.default_rng(76800)
    sys_g, b0_g, prior_g, reg_g, cfg = random_irls_system(rng, 76800, "cuda")
    kb = torch.tensor(1.5, device="cuda")
    ms = cuda_ms(lambda: solve_irls_cuda(sys_g, b0_g, prior_g, reg_g, cfg,
                                         kb=kb), 50)
    plain_ms = cuda_ms(lambda: solve_irls_xla(sys_g, b0_g, prior_g, reg_g,
                                              cfg, kb=kb), 10)
    print(f"[K3 irls] ok: n 76800 and 1500, kb 1.05 and 1.5: twist/b_segm "
          f"rtol 2e-4, est_cov rtol 2e-3 of the plain loop on the CPU; "
          f"n=76800 {ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _counters():
    from staticfusion_tpu_torch.kernels.bilateral import \
        bilateral_filter_mm_cuda
    from staticfusion_tpu_torch.kernels.irls import solve_irls_cuda
    from staticfusion_tpu_torch.kernels.smallsolve import (spd_inverse_cuda,
                                                           spd_solve_cuda)
    return {"bilateral_filter_mm": bilateral_filter_mm_cuda,
            "spd_solve": spd_solve_cuda, "spd_inverse": spd_inverse_cuda,
            "irls_solve": solve_irls_cuda}


def phase_main(card):
    import torch

    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.io import synthetic
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    cfg = SFConfig()
    frames, gt = synthetic.make_sequence(cfg, FRAMES, TWIST, seed=0)
    slam = SlamSystem(cfg, device="cuda")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    events = []
    outs = []
    for i, (rgb, depth, _) in enumerate(frames):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs.append(slam.process(rgb, depth, i / 30.0))
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    ms = [e0.elapsed_time(e1) for e0, e1 in events]
    steady = ms[3:]
    n_pix = cfg.rows * cfg.cols
    counts = [int(o.surfel_count) for o in outs if o is not None]
    for o in outs[1:]:
        for f in ("curr_pose", "static_prob", "b_segm"):
            check(bool(torch.isfinite(getattr(o, f)).all()),
                  f"main path: non-finite {f}")
    check(all(0.9 * n_pix < c < 1.5 * n_pix for c in counts),
          f"main path: surfel counts not stable near {n_pix}: {counts}")
    ate = slam.ate(np.arange(FRAMES) / 30.0, gt)
    check(np.isfinite(ate) and ate < ATE_LIMIT,
          f"main path: ATE {ate} m >= {ATE_LIMIT}")
    check(launches["bilateral_filter_mm"] >= FRAMES - 1,
          f"main path: K1 launched {launches['bilateral_filter_mm']} times")
    check(launches["irls_solve"] >= FRAMES - 1,
          f"main path: K3 launched {launches['irls_solve']} times")
    check(launches["spd_solve"] > 0 and launches["spd_inverse"] > 0,
          f"main path: K2 launches {launches}")
    med = float(np.median(steady))
    print(f"[main] ok: {FRAMES} frames QVGA F=4 post 2: ATE {ate:.5f} m, "
          f"surfels {counts[0]}..{counts[-1]} (min {min(counts)}, max "
          f"{max(counts)}), launches {launches}; median "
          f"{med:.3f} ms/frame over frames 3..{FRAMES - 1} "
          f"(min {min(steady):.3f}, max {max(steady):.3f}) on {card}",
          flush=True)
    print("  ms/frame: " + " ".join(f"{m:.1f}" for m in ms), flush=True)
    return launches, med


def phase_cross():
    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.io import synthetic
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    cfg = SFConfig()
    frames, _ = synthetic.make_sequence(cfg, CROSS_FRAMES, TWIST, seed=0)
    gpu = SlamSystem(cfg, device="cuda")
    cpu = SlamSystem(cfg, device="cpu")
    worst_pose = worst_count = 0.0
    for i, (rgb, depth, _) in enumerate(frames):
        og = gpu.process(rgb, depth, i / 30.0)
        oc = cpu.process(rgb, depth, i / 30.0)
        if og is None:
            continue
        dp = float((og.curr_pose.cpu() - oc.curr_pose).abs().max())
        ng, nc = int(og.surfel_count), int(oc.surfel_count)
        dc = abs(ng - nc) / max(nc, 1)
        worst_pose, worst_count = max(worst_pose, dp), max(worst_count, dc)
        print(f"  frame {i}: |pose diff| {dp:.3e}, surfels {ng} vs {nc}",
              flush=True)
    check(worst_pose <= POSE_TOL,
          f"card vs CPU: pose differs by {worst_pose} > {POSE_TOL}")
    check(worst_count <= COUNT_TOL,
          f"card vs CPU: surfel counts differ by {worst_count:.4f}")
    print(f"[cross] ok: {CROSS_FRAMES} frames, card vs CPU pose within "
          f"{worst_pose:.3e} (<= {POSE_TOL}), surfel counts within "
          f"{worst_count:.4%}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test "
              "needs an NVIDIA GPU", flush=True)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "staticfusion_tpu_torch")):
        print("FAIL: staticfusion_tpu_torch/ not found beside "
              "chip_smoke.py; run from a checkout of the repository",
              flush=True)
        return 1
    sys.path.insert(0, here)
    import staticfusion_tpu_torch  # noqa: F401  (sets TF32 off)
    try:
        card = phase_device()
        phase_build()
        k1 = phase_k1()
        k2s, k2i = phase_k2()
        k3 = phase_k3()
        launches, _ = phase_main(card)
        phase_cross()
    except (SmokeError, AssertionError, RuntimeError, ValueError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    csrc = "staticfusion_tpu_torch/csrc/"
    pallas = "staticfusion_tpu/kernels/"
    rows = [("bilateral_filter_mm", "bilateral.cu",
             "bilateral_pallas.py:116", k1),
            ("spd_solve", "smallsolve.cu", "smallsolve_pallas.py:75", k2s),
            ("spd_inverse", "smallsolve.cu", "smallsolve_pallas.py:93", k2i),
            ("irls_solve", "irls.cu", "irls_pallas.py:242", k3)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src,
         "replaces": pallas + rep, "launches": launches[name], **m}
        for name, src, rep, m in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
