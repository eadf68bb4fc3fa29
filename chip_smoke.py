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
     events) at the main path's shapes, beside the kernel's bound (the
     largest of its bytes over HBM bandwidth, its flop over the float32
     peak and, for K1, its expf over the special-function units' rate)
     and, for K2, beside torch.linalg's call.  K1 (the depth
     preprocessing) at QVGA and VGA; K3 with the motion filter at all
     five QVGA level sizes and at VGA level 0;
  4. main path: SlamSystem(SFConfig()) on the card over a 30-frame
     synthetic static QVGA sequence (seed 0): ATE, finiteness, surfel
     counts, per-kernel launch counts of that run (the standalone K2
     solve must not run: the motion filter runs inside K3), median
     ms/frame;
  5. card vs CPU: the first 6 frames through the port on the card and on
     the CPU, poses and surfel counts compared;
  6. gates: the five adversarial accuracy gates of tests/test_accuracy.py
     through SlamSystem.process_batch on the card, at the test's configs,
     frame counts, seed and thresholds (walk_xyz at F=1 and at the F=4
     default, routed VGA at F=1, fast_rot and static at F=1); per gate ATE,
     IoU, median ms/frame and launches per frame (the counts set to 0
     before each gate and read after it); the generator's time first;
  7. app: the dataset path. apps/make_synthetic_dataset.py writes a
     30-frame 640x480 TUM-layout dataset (PNG, depth at 5000/m) to a
     temporary directory; the native zlib decoder (csrc/io, built by g++)
     must return every frame's arrays exactly; `run_tum` runs it on the
     card at --res-factor 2 (the shipped default config) with --ply,
     --metrics and --checkpoint: ATE, the PLY's vertex count against the
     checkpointed map above the threshold, one metrics row per frame; a
     run stopped after frame 16 with --checkpoint, then --resume over
     frames 17..29, must match the uninterrupted run (poses within 1e-5,
     equal surfel counts per frame).  Per run: median ms/frame (CUDA
     events around slam_step, frames 3..29), for run_tum also the app's
     wall ms/frame (host time from one step's start to the next's, so
     PNG decode and the per-frame host read included) and the run's
     seconds, and the kernel launches (the counts set to 0 before each
     run and read after it);
  8. branches: the main path's sequence at post_factor 4 (= the index
     factor: the post-merge render reuses the association's z-buffer
     winners, materialize_from_winners), ATE and median ms/frame; a
     12-frame run whose map is repacked into 1 << 22 slots after the
     bootstrap (23 id bits: the exact two-pass z-buffer) until the first
     tier check shrinks it, ATE; one render of that map, gather and
     scatter, and its z-buffer verdicts on the card against the CPU:
     identical winner ids;
  9. loop gates: tests/test_keyframes.py's pipeline gates through the
     port on the card at the tests' configs, frames, seeds and thresholds:
     the 16-frame out-and-back (per frame), the 24-frame run through an
     8-slot keyframe DB (process_batch), and the 80-frame mini corridor
     off and on;
  10. corridor: the production corridor_loop profile, 300 frames, at the
     configuration of ACC_r5_corridor_{off,on}_s0.json, loop closure off
     then on: ATE, closures, false closures (T error > 0.5 m against the
     ground truth), DB halvings, median ms/frame over non-tick frames, ms
     per keyframe tick, K3 launches; on must beat off with a closure.
     The JAX package's committed figures are printed beside, not gated;
     per run of phases 8-10 the kernel launches (counts set to 0 before
     it).  The sequence is rendered into the run's own adversarial cache
     ($SF_ADV_CACHE); the on run's row is written by
     apps/accuracy_bench.py's row code and apps/check_closures.py must
     read the same closures and false closures back from it (the
     closures' T errors are check_closures.t_errors, here and in phase
     9);
  11. live: the live path and the viewers at SFConfig().  (a) A producer
     thread sends 60 frames of run_camera's synthetic sequence with the
     port's SFRD writer over a socket pair at 30 Hz, each stamped with
     time.time(); run_camera's loop consumes them on the card, first in
     replay (every frame: 59 poses, ATE < 0.02 m), then drop-to-latest
     (60 received = delivered + dropped, finite poses; ATE printed, not
     gated); capture->pose latency median and p90, launches.  (b)
     render_view of phase 4's final map at its final pose on the card and
     on the CPU: identical texel winners, hit masks agree at >= 99% of
     pixels, rgb within 2/255 at >= 99.9% of common hits (every mode's
     largest difference printed), and its time on the card (CUDA events,
     mean of 20).  (c) run_sequence --html --viz
     --live 0 --live-every 5 over the app phase's dataset: the page holds
     the PLY's points and both trajectories, one panel PNG per processed
     frame read back by the native decoder, and /frame.png,
     /metrics.json and /params.json answer after the run (requests time
     out after 5 s; every socket read and thread join after 60 s); its
     wall ms/frame beside run_tum's;
  12. parallel: the multi-device layer.  A probe of which collectives
     Gloo runs on CUDA tensors (two threads; every pair that
     parallel/mesh.py::GLOO_CUDA hands Gloo unstaged must pass), with the
     time of a z-buffer-sized MIN on the card and staged through the
     host; the one-process reference on the card (bootstrap_step +
     slam_step at QVGA, F=4, post 2, capacity 1 << 18, so the bootstrap's
     98304-slot tier, no tiers after it; 10 frames of the main path's
     sequence); then for meshes 1x2 and 2x1 two rank processes of
     `python -m staticfusion_tpu_torch.apps.run_multihost` on cuda:0 over
     Gloo and a FileStore: every rank's poses equal rank 0's within 1e-6,
     the first steady step within 1e-4 and every pose within 6e-3 of the
     one-process run, surfels within 1%, the state on the card, K1 once
     per frame and K3 as often as in one process on every rank (every
     solve through K3: no plain version, no CPU fallback), K2 never; per
     rank its slots and surfels, its row block, its launches, its
     collective calls and MB by helper and its median ms/frame beside the
     one-process median.  Then `run_multihost --spawn 2` once, and
     `optimize_sharded` on 2 ranks (threads of this process on the card)
     against `optimize` within 1e-5, with the constraints per rank;
  13. tools: the evaluation tools of staticfusion_tpu_torch/apps on the
     card, no CPU fallback.  (a) accuracy_bench.main --profiles walk_xyz
     --factors 4 --frames 40 --seed 1 --json: the row's keys are the JAX
     tool's, fixed_tiers false, ATE < 0.05 m and IoU > 0.55
     (tests/test_accuracy.py's F=4 limits), K1 once a frame, K3 4-6 times
     a frame, K2 never; (b) is phase 10's check_closures read-back; (c)
     `python -m staticfusion_tpu_torch.apps.stream_feed --to
     tcp://127.0.0.1:PORT --frames 60 --fps 30` as a separate process
     feeds run_camera.main --source listen://PORT --replay here: the
     feeder exits 0, 59 poses, ATE < 0.02 m (every join and wait after
     60 s); (d) smoke_e2e: ATE < 0.02 m; (e) calibrate_loop's
     populations on the card and on the CPU: fp_dist within 1e-3
     relative, residual within 1e-3 m (both printed);
  14. profile: torch.profiler counts the device kernels of one K3 call
     at each level size and of one K1 call (exactly one each) and their
     device times, and the device kernels and busy time per main-path
     frame over 3 more frames.  Last, because a profiler run before the
     main path coincided with slower frames;
then the script's total time, a JSON line with the kernels (their
launches on the main path, in each gate, app, branches, loop-gate,
corridor, live, parallel (summed over the mesh's ranks) and tools run, and K3's
launches per keyframe tick of the corridor run),
and last a JSON line
{"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

FRAMES = 30
PROFILE_FRAMES = 3      # more frames of the same sequence, profiled last
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
ATE_LIMIT = 0.02        # metres; the healthy signal of the static sequence
CROSS_FRAMES = 6
# Card vs CPU: float sums differ in order between the two, which can flip
# one IRLS convergence test (a change of up to one IRLS step, ~1.5e-3).
POSE_TOL = 2e-3
COUNT_TOL = 0.01
# Published peaks of one H100 SXM (NVIDIA's data sheet, full 700 W):
# HBM bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Special-function units (MUFU: exp2, rcp, ...): 16 results per clock per
# SM (CUDA C++ Programming Guide, throughput table, compute capability
# 9.0) x 132 SMs x the 1.98 GHz boost clock of the data sheet's peaks.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# QVGA pyramid level sizes, level 0 first (K3's N per solve), and VGA
# level 0 (the routed VGA gate's largest solve).
LEVEL_SIZES = (76800, 19200, 4800, 1200, 300)
VGA_N = 307200
# The app phase: frames of its 640x480 dataset, and the frame its resumed
# run starts at (the first run stops after frame APP_SPLIT - 1).
APP_FRAMES = 30
APP_SPLIT = 17
# The branches phase: frames of the run whose map is repacked into 1 << 22
# slots after the bootstrap (the first tier check comes after frame 8).
BIG_MAP_FRAMES = 12
# The corridor phase: frames of the corridor_loop profile.
CORRIDOR_FRAMES = 300
# The live phase: frames of run_camera's paced socket stream and its rate;
# every socket read and thread join waits at most LIVE_TIMEOUT seconds.
# render_view of the main path's map, card vs CPU: the same texel winners,
# hit masks agree at >= RENDER_HIT_AGREE of pixels, rgb within
# RENDER_RGB_TOL/255 at >= RENDER_RGB_SHARE of the common hits (the splat
# picks the nearest of its candidate disks; two adjacent surfels at
# depths equal to the last bits can swap between card and CPU, which
# changes a pixel's color by a few /255: 1 pixel of 74106 common hits,
# by 4/255, on an H100); its time is the mean over RENDER_REPS calls.
LIVE_FRAMES = 60
LIVE_HZ = 30.0
LIVE_TIMEOUT = 60.0
RENDER_HIT_AGREE = 0.99
RENDER_RGB_TOL = 2
RENDER_RGB_SHARE = 0.999
RENDER_REPS = 20
# Phase 12 (parallel): rank processes of run_multihost on the one card.
PAR_MESHES = ((1, 2), (2, 1))
PAR_FRAMES = 10
PAR_CAPACITY = 1 << 18
PAR_FIRST_TOL = 1e-4    # tests/test_sharding.py's single-step tolerance
PAR_POSE_TOL = 6e-3     # its per-frame tolerance over a sequence
PAR_COUNT_TOL = 0.01
PAR_RANK_TOL = 1e-6     # the ranks of one run print the same poses
PAR_GRAPH_POSES = 64
PAR_GRAPH_TOL = 1e-5
PAR_TIMEOUT = 300       # seconds per rank process
# Phase 13 (tools): the frames of accuracy_bench's walk run, the keys of
# the JAX tool's row (scripts/accuracy_bench.py:98-115), and the
# tolerances of calibrate_loop's populations, card against CPU: fp_dist
# relative; the verification residual (a median over the pair's covisible
# pixels, m) absolute, as tests/test_torch_tools.py holds it against JAX.
# A negative pair's residual moves with the solver's float order: 0.041111
# on an H100 against 0.041010 on its host's CPU (2.5e-3 relative).
TOOLS_FRAMES = 40
JAX_ROW_KEYS = ("profile", "index_factor", "frames", "post_factor",
                "route_factor", "lambda_reg", "seed", "res_factor", "loop",
                "smooth_skip", "closures", "closure_events", "smoothings",
                "db_halvings", "ate_rmse_m", "rpe_rmse_m", "seg_iou", "fps",
                "capacity", "capacity_events", "fixed_tiers")
CALIB_RTOL = 1e-3
CALIB_RESID_ATOL = 1e-3
# tests/test_accuracy.py's gates: (name, profile, width, height, capacity,
# index_factor, frames, ATE limit, IoU floor or None).  Seed 0.
GATES = (
    ("walk_xyz F=1", "walk_xyz", 320, 240, 1 << 18, 1, 30, 0.15, 0.25),
    ("walk_xyz F=4", "walk_xyz", 320, 240, 1 << 18, 4, 30, 0.05, 0.55),
    ("VGA routed", "walk_xyz", 640, 480, 1 << 20, 1, 16, 0.1, 0.35),
    ("fast_rot", "fast_rot", 320, 240, 1 << 18, 1, 30, 0.02, None),
    ("static", "static", 320, 240, 1 << 18, 1, 30, 0.02, None),
)
# Flop per in-image bilateral tap: diff, square, the exponent's FMA, expf
# counted as one, the two weighted sums (an FMA is 2); each tap's expf is
# also one special-function op.
K1_FLOP_PER_TAP = 8
# K3 flop per pixel: per iteration pass 0 (residuals 24 + 4, weights 10,
# weighted rows 14, normal equations 108) and pass 1 (residuals 26,
# sums 6); once the prologue's two sums.
K3_FLOP_PER_PIXEL_ITER = 160 + 32
K3_FLOP_PER_PIXEL_ONCE = 2


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


def bound(nbytes, flop, sfu_ops=0):
    """(bound_ms, bound_by): the least time of the work on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flop / FP32_FLOP_PER_S, sfu_ops / SFU_OPS_PER_S) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def bilateral_taps(rows, cols, r=6):
    """In-image taps of a (2r+1)^2 stencil over a rows x cols image."""
    def per_axis(m):
        return sum(min(x + r, m - 1) - max(x - r, 0) + 1 for x in range(m))
    return per_axis(rows) * per_axis(cols)


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


def phase_k1(shapes=((240, 320), (480, 640))):
    """K1, the depth preprocessing kernel: raw_m exactly and filt_m within
    the bilateral gate (<= 1 mm, < 1e-3 of pixels differ, out-of-range
    centres 0; read back in millimetres) of the plain version on the CPU,
    and the filtered millimetres of the same kernel within that gate."""
    import torch

    from staticfusion_tpu_torch.kernels.bilateral import (
        bilateral_filter_mm_cuda, bilateral_filter_mm_plain,
        preprocess_depth_cuda, preprocess_depth_mm_plain)
    worst = 0.0
    for rows, cols in shapes:
        d = depth_image(np.random.default_rng(rows * 1000 + cols), rows,
                        cols)
        dg = torch.as_tensor(d, device="cuda")
        raw_m, filt_m = (t.cpu() for t in preprocess_depth_cuda(dg, 4.5))
        raw_p, filt_p = preprocess_depth_mm_plain(torch.as_tensor(d), 4.5)
        tag = f"K1 {rows}x{cols}"
        check(torch.equal(raw_m, raw_p), f"{tag}: raw_m not bit-identical")
        filt_mm = bilateral_filter_mm_cuda(dg, 4.5).cpu().numpy()
        want_mm = bilateral_filter_mm_plain(torch.as_tensor(d), 4.5).numpy()
        stats = []
        for what, got, want in (
                ("filt_m", np.rint(filt_m.numpy() * 1000.0),
                 np.rint(filt_p.numpy() * 1000.0)),
                ("filtered mm", filt_mm, want_mm)):
            err = float(np.abs(got - want).max())
            frac = float(np.mean(got != want))
            check(err <= 1.0, f"{tag} {what}: max |diff| {err} mm > 1")
            check(frac < 1e-3, f"{tag} {what}: {frac} of pixels differ")
            check(np.all(got[(d < 300.0) | (d > 4500.0)] == 0.0),
                  f"{tag} {what}: out-of-range centre not zero")
            stats.append(f"{what} max |diff| {err:.0f} mm, {frac:.2e} of "
                         f"pixels differ")
        worst = max(worst, float((filt_m - filt_p).abs().max()))
        print(f"  {rows}x{cols}: raw_m bit-identical; " + "; ".join(stats),
              flush=True)
    d = torch.as_tensor(depth_image(np.random.default_rng(1), 240, 320),
                        device="cuda")
    ms = cuda_ms(lambda: preprocess_depth_cuda(d, 4.5), 200)
    plain_ms = cuda_ms(lambda: preprocess_depth_mm_plain(d, 4.5), 10)
    taps = bilateral_taps(240, 320)
    # Reads the image once, writes raw_m and filt_m.
    bound_ms, bound_by = bound(3 * d.numel() * 4, K1_FLOP_PER_TAP * taps,
                               sfu_ops=taps)
    print(f"[K1 preprocess] ok: 240x320 and 480x640: raw_m bit-identical, "
          f"filt_m within 1 mm and <1e-3 pixels differ; 240x320 {ms:.4f} "
          f"ms vs plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by})", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
    # Times at 6x6 (the motion filter, the main path's shape) and 24x24
    # (the segmentation system), beside torch.linalg's one call for the
    # same function: solve (which checks for errors on the host) and
    # solve_ex (which does not), inv and inv_ex.  The inverse's ridge of
    # 1e-12 is added to the library's input beforehand.
    times = {}
    for n in (6, 24):
        rng = np.random.default_rng(n)
        a = rng.normal(size=(n, n)).astype(np.float32)
        M = torch.as_tensor(a @ a.T + n * np.eye(n, dtype=np.float32),
                            device="cuda")
        b = torch.as_tensor(rng.normal(size=n).astype(np.float32),
                            device="cuda")
        Mr = M + 1e-12 * torch.eye(n, device="cuda")
        times[n] = {
            "solve": cuda_ms(lambda: spd_solve_cuda(M, b), 500),
            "solve_plain": cuda_ms(lambda: spd_solve(M, b), 20),
            "solve_lib": cuda_ms(lambda: torch.linalg.solve(M, b), 200),
            "solve_lib_ex": cuda_ms(lambda: torch.linalg.solve_ex(M, b),
                                    200),
            "inv": cuda_ms(lambda: spd_inverse_cuda(M, 1e-12), 500),
            "inv_plain": cuda_ms(lambda: spd_inverse(M, 1e-12), 20),
            "inv_lib": cuda_ms(lambda: torch.linalg.inv(Mr), 200),
            "inv_lib_ex": cuda_ms(lambda: torch.linalg.inv_ex(Mr), 200)}
        # Cholesky n^3/3, then 2 n^2 per right-hand side.
        times[n]["solve_bound"] = bound(4 * (n * n + 2 * n),
                                        n ** 3 / 3 + 2 * n * n)
        times[n]["inv_bound"] = bound(4 * 2 * n * n,
                                      n ** 3 / 3 + 2 * n ** 3)
    print(f"[K2 smallsolve] ok: n in {{6, 24}} + 8 random n 2..32 at scales "
          f"1e-2..1e2 within rtol 2e-3 of float64", flush=True)
    for n, t in times.items():
        print(f"  {n}x{n} solve {t['solve']:.4f} ms vs plain "
              f"{t['solve_plain']:.4f}, torch.linalg.solve "
              f"{t['solve_lib']:.4f}, solve_ex {t['solve_lib_ex']:.4f}, bound "
              f"{t['solve_bound'][0]:.3e} ({t['solve_bound'][1]}); inverse "
              f"{t['inv']:.4f} ms vs plain {t['inv_plain']:.4f}, "
              f"torch.linalg.inv {t['inv_lib']:.4f}, inv_ex "
              f"{t['inv_lib_ex']:.4f}, bound {t['inv_bound'][0]:.3e} "
              f"({t['inv_bound'][1]})", flush=True)
    t = times[6]
    return ({"max_abs_err": err_solve, "ms": t["solve"],
             "plain_ms": t["solve_plain"], "bound_ms": t["solve_bound"][0],
             "bound_by": t["solve_bound"][1], "library_ms": t["solve_lib"]},
            {"max_abs_err": err_inv, "ms": t["inv"],
             "plain_ms": t["inv_plain"], "bound_ms": t["inv_bound"][0],
             "bound_by": t["inv_bound"][1], "library_ms": t["inv_lib"]})


def random_filter_inputs(rng, wide=False):
    """(twist_old, accumulated twist) on the CPU: the previous frame's
    twist and the log of a level's accumulated transform.  `wide`: the
    first coarse iteration of a wide-baseline keyframe solve
    (keyframes.relative_pose seeded with T_init): no previous twist, and
    a transform of metres and tens of degrees."""
    import torch

    from staticfusion_tpu_torch.geometry import se3
    if wide:
        xi = np.array([1.5, -0.4, 2.0, 0.2, -0.5, 0.3], np.float32)
        xi += rng.normal(0.0, 0.05, 6).astype(np.float32)
        return torch.zeros(6), se3.se3_log(se3.se3_exp(torch.as_tensor(xi)))
    twist_old = torch.as_tensor(rng.normal(0.0, 0.01, 6).astype(np.float32))
    T = se3.se3_exp(torch.as_tensor(
        rng.normal(0.0, 0.01, 6).astype(np.float32)))
    return twist_old, se3.se3_log(T)


def phase_k3():
    """K3 with and without the motion filter in its epilogue against the
    plain loop (and motion_filter) on the CPU; times of the main path's
    call (filter on) at each level size."""
    import torch

    from staticfusion_tpu_torch.kernels.irls import (OUT_FILT, OUT_ITERS,
                                                     OUT_TWIST,
                                                     irls_solve_flat,
                                                     motion_filter,
                                                     solve_irls_cuda,
                                                     solve_irls_filtered_cuda,
                                                     solve_irls_xla)
    worst = 0.0
    for n in LEVEL_SIZES + (1500, VGA_N):
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
    # The motion filter inside the launch: the cf/df of levels 0 and 4 at
    # every level size, against solve_irls_xla + motion_filter on the CPU,
    # for tracking inputs and for a wide-baseline solve's.
    for n in LEVEL_SIZES:
        for level, wide in ((0, False), (4, False), (0, True), (4, True)):
            rng = np.random.default_rng(n)
            sys_g, b0_g, prior_g, reg_g, cfg = random_irls_system(rng, n,
                                                                  "cuda")
            rng = np.random.default_rng(n)
            sys_c, b0_c, prior_c, reg_c, _ = random_irls_system(rng, n,
                                                                "cpu")
            old, acc = random_filter_inputs(np.random.default_rng(n + level),
                                            wide)
            kb = torch.tensor(1.5, device="cuda")
            got, twist = solve_irls_filtered_cuda(
                sys_g, b0_g, prior_g, reg_g, cfg, old.cuda(), acc.cuda(),
                level, kb=kb)
            want = solve_irls_xla(sys_c, b0_c, prior_c, reg_c, cfg,
                                  kb=torch.tensor(1.5))
            want_twist = motion_filter(want.twist, want.est_cov, old, acc,
                                       level, cfg)
            tag = (f"K3 + motion filter n={n} level={level}"
                   f"{' wide baseline' if wide else ''}")
            np.testing.assert_allclose(twist.cpu().numpy(),
                                       want_twist.numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=tag)
            # The filter leaves the loop's outputs as they were.
            plain_launch = solve_irls_cuda(sys_g, b0_g, prior_g, reg_g, cfg,
                                           kb=kb)
            for f in got._fields:
                check(torch.equal(getattr(got, f),
                                  getattr(plain_launch, f)),
                      f"{tag}: {f} differs from the unfiltered launch")
            worst = max(worst, float((twist.cpu() - want_twist).abs().max()))
    print(f"[K3 irls] ok: n {', '.join(map(str, LEVEL_SIZES))}, 1500 and "
          f"{VGA_N}, kb "
          f"1.05 and 1.5: twist/b_segm rtol 2e-4, aver_res rtol 1e-4, "
          f"est_cov rtol 2e-3 of the plain loop on the CPU; motion filter "
          f"of levels 0 and 4 in the launch, tracking and wide-baseline "
          f"(T_odo of metres, twist_old 0) inputs: rtol 2e-4 of "
          f"solve_irls_xla + motion_filter", flush=True)

    kb = torch.tensor(1.5, device="cuda")
    by_n, systems = {}, {}
    for n in LEVEL_SIZES + (VGA_N,):
        args = random_irls_system(np.random.default_rng(n), n, "cuda")
        old, acc = (t.cuda() for t in random_filter_inputs(
            np.random.default_rng(n)))
        systems[n] = (args, old, acc)
        flat = irls_solve_flat(*args, kb=kb)
        check(torch.equal(flat, irls_solve_flat(*args, kb=kb)),
              f"K3 n={n}: two runs differ")
        check(torch.equal(flat[OUT_FILT:OUT_FILT + 6],
                          flat[OUT_TWIST:OUT_TWIST + 6]),
              f"K3 n={n}: filter off, yet the filtered twist differs")
        iters = int(flat[OUT_ITERS])
        ms_unfiltered = cuda_ms(lambda: solve_irls_cuda(*args, kb=kb), 200)
        ms = cuda_ms(lambda: solve_irls_filtered_cuda(*args, old, acc, 0,
                                                      kb=kb), 200)
        def plain():
            r = solve_irls_xla(*args, kb=kb)
            return motion_filter(r.twist, r.est_cov, old, acc, 0, args[-1])
        plain_ms = cuda_ms(plain, 10)
        # Each input read once: A_c, A_d (12 floats), B_c, B_d, label per
        # pixel; the per-cluster inputs and reg; the two filter inputs;
        # the flat output.
        nbytes = 4 * (15 * n + 4 * 24 + 24 * 24 + 2 + 12 + 75)
        bound_ms, bound_by = bound(
            nbytes, n * (K3_FLOP_PER_PIXEL_ONCE
                         + iters * K3_FLOP_PER_PIXEL_ITER))
        by_n[n] = {"ms": ms, "ms_without_filter": ms_unfiltered,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "iterations": iters}
        print(f"  n={n}: {ms:.4f} ms with the filter ({ms_unfiltered:.4f} "
              f"without) vs plain {plain_ms:.4f} ms, {iters} iterations, "
              f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)
    top = by_n[LEVEL_SIZES[0]]
    return {"max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "by_n": {str(n): v for n, v in by_n.items()}}, systems


def _counters():
    from staticfusion_tpu_torch.kernels.bilateral import (
        bilateral_filter_mm_cuda, preprocess_depth_cuda)
    from staticfusion_tpu_torch.kernels.irls import solve_irls_cuda
    from staticfusion_tpu_torch.kernels.smallsolve import (spd_inverse_cuda,
                                                           spd_solve_cuda)
    return {"preprocess_depth": preprocess_depth_cuda,
            "bilateral_filter_mm": bilateral_filter_mm_cuda,
            "spd_solve": spd_solve_cuda, "spd_inverse": spd_inverse_cuda,
            "irls_solve": solve_irls_cuda}


def phase_main(card):
    import torch

    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.io import synthetic
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    cfg = SFConfig()
    frames, gt = synthetic.make_sequence(cfg, FRAMES + PROFILE_FRAMES, TWIST,
                                         seed=0)
    slam = SlamSystem(cfg)  # the card is the default device
    check(slam.device.type == "cuda", f"main path: on {slam.device}")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    events = []
    outs = []
    for i, (rgb, depth, _) in enumerate(frames[:FRAMES]):
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
    ate = slam.ate(np.arange(FRAMES) / 30.0, gt[:FRAMES])
    check(np.isfinite(ate) and ate < ATE_LIMIT,
          f"main path: ATE {ate} m >= {ATE_LIMIT}")
    check(launches["preprocess_depth"] >= FRAMES - 1,
          f"main path: K1 launched {launches['preprocess_depth']} times")
    check(launches["irls_solve"] >= FRAMES - 1,
          f"main path: K3 launched {launches['irls_solve']} times")
    # The motion filter's solve and the covariance inverse run inside K3's
    # launch.
    check(launches["spd_solve"] == 0,
          f"main path: K2 solve launched {launches['spd_solve']} times")
    check(launches["spd_inverse"] == 0,
          f"main path: K2 inverse launched {launches['spd_inverse']} times")
    med = float(np.median(steady))
    print(f"[main] ok: {FRAMES} frames QVGA F=4 post 2: ATE {ate:.5f} m, "
          f"surfels {counts[0]}..{counts[-1]} (min {min(counts)}, max "
          f"{max(counts)}), launches {launches}; median "
          f"{med:.3f} ms/frame over frames 3..{FRAMES - 1} "
          f"(min {min(steady):.3f}, max {max(steady):.3f}) on {card}",
          flush=True)
    print("  launches per frame: " + ", ".join(
        f"{name} {v / FRAMES:.3f}" for name, v in launches.items()),
        flush=True)
    print("  ms/frame: " + " ".join(f"{m:.1f}" for m in ms), flush=True)
    return launches, (slam, frames[FRAMES:])


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _is_kernel(event):
    return not event.name.startswith(("Memcpy", "Memset"))


def phase_profile(k1, k3, systems, main_run):
    """One torch.profiler session (one, because a profiler session once
    missed the kernel of a one-call session) over, first, one K3 call per
    level size with the motion filter (the main path's) and one without
    it, and 20 K1 calls at QVGA and at VGA, each call run twice (warm-up,
    then timed) with a synchronize after each run; then PROFILE_FRAMES
    more frames of the main path.  Each kernel call must be exactly one device kernel (the
    device operations, in launch order, name the kernels called, and the
    frames' K1 and K3 kernels match their launch counters).  Reports the
    kernels' device times and the device kernels and busy time per frame.
    Runs after the main path: run before it, the profiler coincided with
    slower frames (its hooks may outlive it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from staticfusion_tpu_torch.kernels.bilateral import preprocess_depth_cuda
    from staticfusion_tpu_torch.kernels.irls import (solve_irls_cuda,
                                                     solve_irls_filtered_cuda)
    kb = torch.tensor(1.5, device="cuda")
    calls = []  # (kernel name, where its device time goes, call)
    for n, (args, old, acc) in systems.items():
        calls.append(("irls_solve_kernel", (k3["by_n"][str(n)], "device_us"),
                      lambda a=args, o=old, c=acc: solve_irls_filtered_cuda(
                          *a, o, c, 0, kb=kb)))
        calls.append(("irls_solve_kernel",
                      (k3["by_n"][str(n)], "device_us_without_filter"),
                      lambda a=args: solve_irls_cuda(*a, kb=kb)))
    reps = 20
    for rows, cols in ((240, 320), (480, 640)):
        d = torch.as_tensor(depth_image(np.random.default_rng(1), rows, cols),
                            device="cuda")
        key = f"device_us_{rows}x{cols}"
        k1[key] = []
        calls += [("preprocess_kernel", (k1, key),
                   lambda d=d: preprocess_depth_cuda(d, 4.5))] * reps
    slam, frames = main_run
    counters = _counters()
    before = {name: fn.launches for name, fn in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _, _, call in calls:
            call()
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
        first = len(slam.times)
        for i, (rgb, depth, _) in enumerate(frames):
            slam.process(rgb, depth, (first + i) / 30.0)
        torch.cuda.synchronize()
    launched = {name: fn.launches - before[name]
                for name, fn in counters.items()}
    dev = sorted(_device_events(prof), key=lambda e: e.time_range.start)
    check(len(dev) >= 2 * len(calls),
          f"profile: {len(dev)} device operations for {2 * len(calls)} "
          "kernel calls and the frames")
    for i, (name, (where, key), _) in enumerate(calls):
        warm, timed = dev[2 * i], dev[2 * i + 1]
        check(name in warm.name and name in timed.name,
              f"profile: call {i} ran {warm.name!r}, {timed.name!r}, "
              f"expected one {name} each")
        us = timed.time_range.elapsed_us()
        if isinstance(where.get(key), list):
            where[key].append(us)
        else:
            where[key] = us
    for rows, cols in ((240, 320), (480, 640)):
        key = f"device_us_{rows}x{cols}"
        k1[key] = float(np.median(k1[key]))
    k1["device_us"] = k1["device_us_240x320"]
    k3["device_us"] = k3["by_n"][str(LEVEL_SIZES[0])]["device_us"]

    frame_ops = dev[2 * len(calls):]
    kernels = [e for e in frame_ops if _is_kernel(e)]
    for name, counter in (("irls_solve_kernel", "irls_solve"),
                          ("preprocess_kernel", "preprocess_depth")):
        seen = sum(name in e.name for e in kernels)
        in_frames = launched[counter] - 2 * sum(c[0] == name for c in calls)
        check(seen == in_frames, f"profile: the frames ran {seen} {name}, "
              f"their launch counter says {in_frames}")
    n_frames = len(frames)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print("[profile] ok: one K3 call = 1 device kernel at every n, device "
          "us with the motion filter (without): " + ", ".join(
              f"n={n} {v['device_us']:.1f} "
              f"({v['device_us_without_filter']:.1f})"
              for n, v in k3["by_n"].items())
          + f"; one K1 call = 1 device kernel, median device us over {reps}: "
          f"240x320 {k1['device_us_240x320']:.2f}, 480x640 "
          f"{k1['device_us_480x640']:.2f}", flush=True)
    print(f"[profile] main path, frames {first}..{first + n_frames - 1}: "
          f"{len(kernels) / n_frames:.1f} device kernels/frame, "
          f"{(len(frame_ops) - len(kernels)) / n_frames:.1f} "
          f"memcpy+memset/frame, kernel busy {busy_ms / n_frames:.3f} "
          f"ms/frame", flush=True)


@contextlib.contextmanager
def timed_slam_step(host_starts=None):
    """Time every slam_step that SlamSystem runs with CUDA events; yields
    the list of (start, end) event pairs, one per step.  A list given as
    `host_starts` gets the host clock (s) at the start of every step."""
    import torch

    import staticfusion_tpu_torch.pipeline.system as system_mod
    step = system_mod.slam_step
    events = []

    def timed_step(state, frame, config):
        if host_starts is not None:
            host_starts.append(time.perf_counter())
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(state, frame, config)
        e1.record()
        events.append((e0, e1))
        return out

    system_mod.slam_step = timed_step
    try:
        yield events
    finally:
        system_mod.slam_step = step


def phase_gates(card):
    """tests/test_accuracy.py's five gates through the port on the card.
    Each walk_xyz QVGA sequence is rendered once and serves both walk
    gates.  Per gate: ATE and mean IoU against the test's limits, the
    median of per-frame CUDA-event times around slam_step (frames after
    the bootstrap, the first steady frame excluded), and the kernel
    launches of its process_batch run."""
    import torch

    import staticfusion_tpu_torch.pipeline.system as system_mod
    from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                               SFConfig)
    from staticfusion_tpu_torch.io import adversarial as adv
    t0 = time.perf_counter()
    sequences = {}
    for _, profile, w, h, _, _, n, _, _ in GATES:
        if (profile, w, h) not in sequences:
            cfg = SFConfig(camera=CameraConfig(width=w, height=h))
            sequences[(profile, w, h)] = adv.make_adversarial_sequence(
                cfg, n, profile, seed=0)
    gen_s = time.perf_counter() - t0
    print(f"[gates] generator: {len(sequences)} sequences "
          f"({sum(len(f) for f, _ in sequences.values())} frames) in "
          f"{gen_s:.1f} s on the host", flush=True)

    counters = _counters()
    results = {}
    with timed_slam_step() as events:
        for name, profile, w, h, cap, factor, n, ate_max, iou_min in GATES:
            config = SFConfig(camera=CameraConfig(width=w, height=h),
                              fusion=FusionConfig(capacity=cap,
                                                  index_factor=factor))
            frames, gt = sequences[(profile, w, h)]
            check(len(frames) == n, f"{name}: {len(frames)} frames")
            slam = system_mod.SlamSystem(config)
            check(slam.device.type == "cuda", f"{name}: on {slam.device}")
            events.clear()
            for fn in counters.values():
                fn.launches = 0
            t1 = time.perf_counter()
            probs = slam.process_batch(
                [f[0] for f in frames], [f[1] for f in frames],
                [i / 30.0 for i in range(n)], collect_prob=True)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
            launches = {k: fn.launches for k, fn in counters.items()}
            probs = probs.cpu().numpy()
            check(probs.shape == (n - 1, h, w) and np.isfinite(probs).all(),
                  f"{name}: static_prob stack {probs.shape}")
            ious = [adv.dynamic_iou(probs[i - 1], frames[i][2],
                                    frames[i][1])
                    for i in range(1, n)
                    if i >= config.buffer_length and frames[i][2].sum() > 50]
            iou = float(np.mean(ious)) if ious else None
            ate = slam.ate(np.arange(n) / 30.0, gt)
            ms = [e0.elapsed_time(e1) for e0, e1 in events]
            med = float(np.median(ms[1:]))
            check(launches["preprocess_depth"] >= n - 1,
                  f"{name}: K1 launched {launches['preprocess_depth']} times")
            check(launches["irls_solve"] >= n - 1,
                  f"{name}: K3 launched {launches['irls_solve']} times")
            check(launches["spd_solve"] == 0 and launches["spd_inverse"] == 0,
                  f"{name}: K2 launched standalone: {launches}")
            if name == "VGA routed":
                check(config.fusion.route_factor == 0,
                      "VGA routed: route_factor is not auto")
            ok = np.isfinite(ate) and ate < ate_max and (
                iou_min is None or (iou is not None and iou > iou_min))
            results[name] = {"ate": ate, "iou": iou, "ms": med,
                             "launches": launches, "ok": ok}
            print(f"  {name}: {w}x{h} F={factor} capacity {cap}, {n} frames: "
                  f"ATE {ate:.5f} m (< {ate_max}), IoU "
                  f"{'n/a' if iou is None else f'{iou:.4f}'}"
                  f"{'' if iou_min is None else f' (> {iou_min})'}; median "
                  f"{med:.3f} ms/frame over frames 3..{n - 1} (min "
                  f"{min(ms[1:]):.3f}, max {max(ms[1:]):.3f}), run "
                  f"{run_s:.1f} s; launches per frame: " + ", ".join(
                      f"{k} {v / n:.3f}" for k, v in launches.items())
                  + f"; surfels {slam.total_surfels()} "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
    failed = [k for k, v in results.items() if not v["ok"]]
    check(not failed, f"gates failed: {failed}")
    print(f"[gates] ok: all {len(GATES)} gates of tests/test_accuracy.py "
          f"pass through the port on {card}; generator {gen_s:.1f} s",
          flush=True)
    return results


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


def _app_run(argv, counters):
    """One run of an app's main(argv) with the launch counts set to 0
    before it: -> (launches, per-step ms, per-frame wall ms, seconds).
    The wall ms of a frame is the host time from one step's start to the
    next's: the step, the app's per-frame host read and metrics row, and
    the next frame's PNG decode."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    starts = []
    with timed_slam_step(starts) as events:
        t0 = time.perf_counter()
        argv[0](argv[1:])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    return ({k: fn.launches for k, fn in counters.items()},
            [e0.elapsed_time(e1) for e0, e1 in events],
            [1e3 * (b - a) for a, b in zip(starts, starts[1:])], run_s)


def _app_launch_check(tag, launches, n):
    check(launches["preprocess_depth"] >= n - 1,
          f"{tag}: K1 launched {launches['preprocess_depth']} times")
    check(launches["irls_solve"] >= n - 1,
          f"{tag}: K3 launched {launches['irls_solve']} times")
    check(launches["spd_solve"] == 0 and launches["spd_inverse"] == 0,
          f"{tag}: K2 launched standalone: {launches}")


def phase_app(card, tmp):
    """The dataset path through the port's apps on the card (phase 7 of
    the module docstring), in directory `tmp`.  Returns ({run: launches},
    the dataset's directory, run_tum's wall median ms/frame)."""
    from staticfusion_tpu_torch.apps import make_synthetic_dataset as mkdata
    from staticfusion_tpu_torch.apps import run_sequence, run_tum
    from staticfusion_tpu_torch.config import CameraConfig, SFConfig
    from staticfusion_tpu_torch.io import native, synthetic
    from staticfusion_tpu_torch.io.ply import load_ply_count
    from staticfusion_tpu_torch.io.tum import load_assoc
    from staticfusion_tpu_torch.utils import checkpoint
    counters = _counters()
    n, split = APP_FRAMES, APP_SPLIT
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    cfg = SFConfig(camera=CameraConfig(width=640, height=480))
    frames, poses = synthetic.make_sequence(cfg, n, mkdata.TWIST)
    mkdata.write_dataset(data, frames, poses)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    entries = load_assoc(data)
    for i, (e, (rgb, depth_mm, _)) in enumerate(zip(entries, frames)):
        want_rgb, want_depth = mkdata.encode_frame(rgb, depth_mm)
        for path, want in ((e.rgb_path, want_rgb),
                           (e.depth_path, want_depth)):
            got = native.decode_png(path)
            check(got is not None and got.dtype == want.dtype
                  and np.array_equal(got, want),
                  f"app: frame {i}: {path} does not decode to the "
                  "arrays it was written from")
    print(f"[app] dataset: {n} frames 640x480 (PNG, depth 5000/m) "
          f"written in {write_s:.2f} s; the native decoder "
          f"({os.path.relpath(lib)}, g++ {build_s:.1f} s) returns every "
          f"frame's arrays exactly", flush=True)

    # run_tum: the trajectory goes to ./odometry_results/ under tmp.
    out = {k: os.path.join(tmp, v) for k, v in (
        ("ply", "map.ply"), ("metrics", "full.jsonl"),
        ("ckpt", "full.npz"), ("a", "a.npz"), ("b", "b.npz"),
        ("b_traj", "b.txt"), ("b_metrics", "b.jsonl"),
        ("a_traj", "a.txt"), ("rest", "rest_assoc.txt"))}
    with contextlib.chdir(tmp):
        launches, ms, wall, run_s = _app_run(
            [run_tum.main, data, "--res-factor", "2", "--ply",
             out["ply"], "--metrics", out["metrics"], "--checkpoint",
             out["ckpt"]], counters)
    traj = os.path.join(tmp, "odometry_results", "experiment_000.txt")
    check(os.path.isfile(traj), "app: run_tum wrote no "
          "odometry_results/experiment_000.txt")
    _app_launch_check("app run_tum", launches, n)
    rows = [json.loads(line) for line in open(out["metrics"])]
    frame_rows = [r for r in rows if "frame" in r]
    check([r["frame"] for r in frame_rows] == list(range(1, n)),
          f"app: metrics rows for frames "
          f"{[r['frame'] for r in frame_rows]}, expected 1..{n - 1}")
    ate, rpe = rows[-1].get("ate_rmse"), rows[-1].get("rpe_rmse")
    check(ate is not None and np.isfinite(ate) and ate < ATE_LIMIT,
          f"app: run_tum ATE {ate} m >= {ATE_LIMIT}")
    thr = SFConfig().fusion.confidence_threshold
    state = checkpoint.load_state(out["ckpt"])
    archive = checkpoint.load_archive(out["ckpt"])
    above = sum(int(((m.conf > thr) & m.valid).sum())
                for m in (state.smap, archive) if m is not None)
    n_ply = load_ply_count(out["ply"])
    check(n_ply == above, f"app: PLY has {n_ply} vertices, the map "
          f"{above} above {thr}")
    check(int(state.tick) == n, f"app: checkpoint tick {int(state.tick)}")
    med = float(np.median(ms[1:]))
    check(len(ms) == n - 2 and len(wall) == n - 3,
          f"app: {len(ms)} steps, {len(wall)} step-to-step times")
    wall_med = float(np.median(wall[1:]))
    print(f"  run_tum (QVGA F=4 post 2, --res-factor 2): {n - 1} poses, "
          f"ATE {ate:.5f} m (< {ATE_LIMIT}), RPE {rpe:.5f} m, PLY "
          f"{n_ply} vertices = checkpointed map above {thr}, "
          f"{len(frame_rows)} metrics rows for frames 1..{n - 1}; step "
          f"median {med:.3f} ms/frame over frames 3..{n - 1} (min "
          f"{min(ms[1:]):.3f}, max {max(ms[1:]):.3f}); app wall median "
          f"{wall_med:.3f} ms/frame, step start to step start from "
          f"frames 3..{n - 2} (min {min(wall[1:]):.3f}, max "
          f"{max(wall[1:]):.3f}); run {run_s:.3f} s for {n} frames "
          f"({1e3 * run_s / n:.3f} ms/frame with set-up, PLY and "
          f"checkpoint); launches K1 {launches['preprocess_depth']}, K3 "
          f"{launches['irls_solve']}, K2 {launches['spd_solve']}; on "
          f"{card}", flush=True)
    results = {"app run_tum": launches}

    # Stop after frame split - 1 with a checkpoint, resume over the rest.
    seq = [run_sequence.main, data, "--res-factor", "2",
           "--depth-scale", "5000"]
    launches_a, _, _, _ = _app_run(
        seq + ["--max-frames", str(split), "--out", out["a_traj"],
               "--checkpoint", out["a"], "--metrics", os.devnull],
        counters)
    with open(os.path.join(data, "rgbd_assoc.txt")) as f:
        lines = f.read().splitlines()
    with open(out["rest"], "w") as f:
        f.write("\n".join(lines[split:]) + "\n")
    launches_b, _, _, res_s = _app_run(
        seq + ["--resume", out["a"], "--assoc", out["rest"], "--out",
               out["b_traj"], "--checkpoint", out["b"], "--metrics",
               out["b_metrics"]], counters)
    _app_launch_check("app resume", launches_b, n - split)
    from staticfusion_tpu_torch.io.trajectory import read_tum_trajectory
    t_full, p_full = read_tum_trajectory(traj)
    t_b, p_b = read_tum_trajectory(out["b_traj"])
    check(len(t_b) == n - split and np.array_equal(
        t_b, t_full[-(n - split):]), f"app: resumed run wrote {len(t_b)} "
          f"poses, expected frames {split}..{n - 1}")
    pose_diff = float(np.abs(p_b - p_full[-(n - split):]).max())
    b_state = checkpoint.load_state(out["b"])
    state_diff = float((b_state.curr_pose - state.curr_pose).abs().max())
    check(max(pose_diff, state_diff) <= 1e-5,
          f"app: resumed poses differ by {pose_diff} (final state "
          f"{state_diff}) > 1e-5")
    b_rows = [json.loads(line) for line in open(out["b_metrics"])]
    got = [r["surfels"] for r in b_rows if "frame" in r]
    want = [r["surfels"] for r in frame_rows[split - 1:]]
    check(got == want, f"app: resumed surfel counts {got}, "
          f"uninterrupted {want}")
    print(f"  resume after frame {split - 1}: frames {split}..{n - 1} of "
          f"the resumed run vs the uninterrupted run: max |pose diff| "
          f"{pose_diff:.3e} (final state {state_diff:.3e}; <= 1e-5), "
          f"surfel counts equal at every frame ({got[-1]} at the end); "
          f"resumed run {res_s:.1f} s; launches K1 "
          f"{launches_b['preprocess_depth']}, K3 "
          f"{launches_b['irls_solve']}", flush=True)
    results["app first part"] = launches_a
    results["app resume"] = launches_b
    print(f"[app] ok: run_tum and resume on {card}", flush=True)
    return results, data, wall_med


def _run_frames(slam, frames, batch: bool, counters, probs_out=None):
    """Frames through `slam` (per frame through `process`, or one
    `process_batch` call) with the launch counts set to 0 before: ->
    (launches, per-step ms by recorded frame, keyframe ticks, K3 launches
    in the ticks' closure work, seconds).  A list given as `probs_out`
    (batch only) gets process_batch's static-probability stack.  Each slam_step is timed with
    CUDA events; each keyframe tick's closure work (SlamSystem.
    _maybe_close_loop: fingerprint, query, verification, pose graph,
    deformation) too, and a tick's ms is its step's plus that."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    ticks, tick_k3 = {}, [0]
    inner = slam._maybe_close_loop

    def timed_close(frame, out):
        if len(slam.times) % slam._kf_stride:
            return inner(frame, out)   # not a keyframe tick
        k3 = counters["irls_solve"].launches
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(frame, out)
        e1.record()
        ticks[len(slam.times)] = (e0, e1)
        tick_k3[0] += counters["irls_solve"].launches - k3
        return out
    slam._maybe_close_loop = timed_close
    starts = []   # len(slam.times) at each recorded frame
    record = slam._record
    slam._record = lambda ts, out: (starts.append(len(slam.times)),
                                    record(ts, out))
    t0 = time.perf_counter()
    with timed_slam_step() as events:
        if batch:
            probs = slam.process_batch(
                [f[0] for f in frames], [f[1] for f in frames],
                [i / 30.0 for i in range(len(frames))],
                collect_prob=probs_out is not None)
            if probs_out is not None:
                probs_out.append(probs)
        else:
            for i, f in enumerate(frames):
                slam.process(f[0], f[1], i / 30.0)
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    del slam._maybe_close_loop, slam._record
    # One slam_step per recorded frame after the bootstrap frame.
    step_ms = dict(zip(starts[1:], (e0.elapsed_time(e1)
                                    for e0, e1 in events)))
    tick_ms = {n: e0.elapsed_time(e1) for n, (e0, e1) in ticks.items()}
    return ({k: fn.launches for k, fn in counters.items()}, step_ms,
            tick_ms, tick_k3[0], run_s)


def _loop_stats(step_ms, tick_ms):
    """(median ms over non-tick steps, median ms per keyframe tick: its
    step plus its closure work)."""
    plain = [m for n, m in step_ms.items() if n not in tick_ms and n > 0]
    tick = [step_ms.get(n, 0.0) + m for n, m in tick_ms.items() if n > 0]
    return (float(np.median(plain)) if plain else float("nan"),
            float(np.median(tick)) if tick else float("nan"))


def phase_branches(card):
    """The two fuse branches the port gained (module docstring, phase 8):
    post_factor == index_factor over the main path's 30-frame sequence;
    a 12-frame run whose map is repacked into 1 << 22 slots after the
    bootstrap (23 id bits: the two-pass z-buffer in the F=4 association
    and the post-merge render) until the first tier check shrinks it; one
    render of that map on the card against the same render on the CPU."""
    import torch

    from staticfusion_tpu_torch.config import FusionConfig, SFConfig
    from staticfusion_tpu_torch.fusion import sparse, texelmap
    from staticfusion_tpu_torch.fusion.surfels import SurfelMap, compact_map
    from staticfusion_tpu_torch.io import synthetic
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    counters = _counters()
    results = {}
    cfg = SFConfig(fusion=FusionConfig(post_factor=4))
    frames, gt = synthetic.make_sequence(cfg, max(FRAMES, BIG_MAP_FRAMES),
                                         TWIST, seed=0)
    slam = SlamSystem(cfg)
    launches, step_ms, _, _, run_s = _run_frames(slam, frames[:FRAMES],
                                                 False, counters)
    ate = slam.ate(np.arange(FRAMES) / 30.0, gt[:FRAMES])
    _app_launch_check("branches post 4", launches, FRAMES)
    check(np.isfinite(ate) and ate < ATE_LIMIT,
          f"branches post 4: ATE {ate} m >= {ATE_LIMIT}")
    med = float(np.median([m for n, m in step_ms.items() if n >= 2]))
    print(f"  post_factor 4 (= index_factor: materialize_from_winners), "
          f"{FRAMES} frames QVGA: ATE {ate:.5f} m (< {ATE_LIMIT}); median "
          f"{med:.3f} ms/frame over frames 3..{FRAMES - 1}; run {run_s:.1f} "
          f"s; launches K1 {launches['preprocess_depth']}, K3 "
          f"{launches['irls_solve']}; on {card}", flush=True)
    results["branches post 4"] = {"launches": launches}

    big = 1 << 22
    check(texelmap.id_bits_for(big) > texelmap.PACKED_MAX_ID_BITS,
          "branches: 1 << 22 slots do not need the two-pass z-buffer")
    cfg = SFConfig(fusion=FusionConfig(capacity=big))
    n = BIG_MAP_FRAMES
    slam = SlamSystem(cfg)
    for fn in counters.values():
        fn.launches = 0
    for i in range(2):
        slam.process(frames[i][0], frames[i][1], i / 30.0)
    slam.state = slam.state._replace(smap=compact_map(slam.state.smap, big))
    at_big, snap = 0, None
    for i in range(2, n):
        if slam.state.smap.capacity == big:
            at_big += 1
            snap = (slam.state.smap, slam.state.curr_pose, slam.state.tick)
        slam.process(frames[i][0], frames[i][1], i / 30.0)
    launches = {k: fn.launches for k, fn in counters.items()}
    ate = slam.ate(np.arange(n) / 30.0, gt[:n])
    check(at_big >= 5, f"branches 4M: only {at_big} frames at {big} slots")
    check(slam.state.smap.capacity < big,
          "branches 4M: the tier check did not shrink the map")
    check(np.isfinite(ate) and ate < ATE_LIMIT,
          f"branches 4M: ATE {ate} m >= {ATE_LIMIT}")
    print(f"  capacity {big} (two-pass z-buffer): {n} frames, {at_big} of "
          f"them fused into the {big}-slot map before the first tier check "
          f"(then {slam.state.smap.capacity} slots): ATE {ate:.5f} m (< "
          f"{ATE_LIMIT}); launches K1 {launches['preprocess_depth']}, K3 "
          f"{launches['irls_solve']}", flush=True)
    results["branches 4M"] = {"launches": launches}

    smap, pose, tick = snap
    local = texelmap.project_surfels(smap, pose, cfg)
    cpu = lambda t: type(t)(*[a.cpu() for a in t])
    smap_c, local_c = cpu(smap), cpu(local)
    winners = 0
    for mode in ("gather", "scatter"):
        g = texelmap.render_texel_images(smap, local, tick, cfg,
                                         materialize=mode)
        c = texelmap.render_texel_images(smap_c, local_c, tick.cpu(), cfg,
                                         materialize=mode)
        check(torch.equal(g.idx.cpu(), c.idx) and torch.equal(g.has.cpu(),
                                                              c.has),
              f"branches: the {mode} render's winners differ, card vs CPU")
        for f in g._fields[2:]:
            np.testing.assert_allclose(
                getattr(g, f).cpu().numpy(), getattr(c, f).numpy(),
                rtol=1e-6, atol=1e-6, err_msg=f"branches render {mode} {f}")
        winners = int(c.has.sum())
    g_ok, g_win = sparse.zbuffer_winners(smap, local, tick, cfg)
    c_ok, c_win = sparse.zbuffer_winners(smap_c, local_c, tick.cpu(), cfg)
    check(torch.equal(g_win.cpu(), c_win) and torch.equal(g_ok.cpu(), c_ok),
          "branches: zbuffer_winners differ, card vs CPU")
    print(f"[branches] ok: post_factor 4 and the two-pass z-buffer through "
          f"the port on {card}; one render of the {big}-slot map "
          f"({int(smap_c.valid.sum())} surfels, {winners} texels won) "
          f"gather and scatter: winner ids identical card vs CPU, "
          f"attributes within 1e-6", flush=True)
    return results


def _out_and_back(cfg, n):
    """tests/test_keyframes.py's out-and-back: n/2 frames along TWIST,
    then back."""
    import torch

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


def _mini_corridor(cfg, n):
    """test_corridor_exploration_closure_gate's hand-built corridor: a
    3 m out-and-back in a 6 m corridor, no walker, seed 0."""
    import torch

    from staticfusion_tpu_torch.geometry.se3 import se3_exp
    from staticfusion_tpu_torch.io import adversarial as adv
    twists = adv.trajectory_corridor_loop(n, depth=3.0)
    planes = adv.corridor_planes(length=6.0)
    spheres = adv.corridor_clutter(length=6.0)
    rng = np.random.default_rng(0)
    sensor = adv.SensorModel()
    pose = np.eye(4, dtype=np.float32)
    frames, gt = [], []
    for i in range(n):
        frames.append(adv.render_adversarial_frame(
            pose, cfg, i, spheres, planes=planes, sensor=sensor, rng=rng,
            texture_fn=adv._texture_corridor))
        gt.append(pose.copy())
        dT = se3_exp(torch.as_tensor(twists[i])).numpy()
        pose = (pose @ dT).astype(np.float32)
    return frames, np.stack(gt)


def phase_loop_gates(card):
    """tests/test_keyframes.py's three loop-closure pipeline gates through
    the port on the card, at the tests' configs, frame counts, seeds and
    thresholds (module docstring, phase 9)."""
    from staticfusion_tpu_torch.apps import check_closures
    from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                               LoopClosureConfig, SFConfig)
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    counters = _counters()
    base = SFConfig(camera=CameraConfig(width=160, height=120),
                    fusion=FusionConfig(capacity=1 << 16))
    results = {}

    def report(name, slam, launches, step_ms, tick_ms, tick_k3, run_s, extra):
        plain, tick = _loop_stats(step_ms, tick_ms)
        print(f"  {name}: {extra}; closures {len(slam.loop_closures)} "
              f"(frame<-keyframe {[(c['frame'], c['keyframe']) for c in slam.loop_closures]}), "
              f"DB halvings {len(slam.db_halvings)}; median "
              f"{plain:.3f} ms/frame over non-tick frames, {tick:.3f} ms "
              f"per keyframe tick ({len(tick_ms)} ticks); K3 launches "
              f"{launches['irls_solve']} ({tick_k3} in the ticks' closure "
              f"work); run {run_s:.1f} s; on {card}", flush=True)
        results[name] = {"launches": launches}

    # test_loop_closure_fires_in_pipeline: 16 frames, per frame.
    cfg = base.replace(loop=LoopClosureConfig(
        enabled=True, kf_interval=2, capacity=16, min_gap=5,
        max_fp_dist=0.005, max_residual=0.05))
    frames, gt = _out_and_back(cfg, 16)
    slam = SlamSystem(cfg)
    run = _run_frames(slam, frames, False, counters)
    ate = slam.ate(np.arange(16) / 30.0, gt)
    check(len(slam.loop_closures) >= 1, "loop fires: no closure")
    for c in slam.loop_closures:
        check(c["frame"] - c["keyframe"] >= cfg.loop.min_gap
              and c["residual"] < cfg.loop.max_residual,
              f"loop fires: closure {c['frame']}<-{c['keyframe']} "
              f"residual {c['residual']}")
    check(ate < 0.03, f"loop fires: ATE {ate} >= 0.03")
    report("loop fires", slam, *run, f"16 frames 160x120, ATE {ate:.5f} m "
           "(< 0.03)")

    # test_loop_closure_survives_db_capacity: 24 frames, process_batch.
    cfg = base.replace(loop=LoopClosureConfig(
        enabled=True, kf_interval=1, capacity=8, min_gap=5,
        max_fp_dist=0.005, max_residual=0.05))
    frames, gt = _out_and_back(cfg, 24)
    slam = SlamSystem(cfg)
    run = _run_frames(slam, frames, True, counters)
    ate = slam.ate(np.arange(24) / 30.0, gt)
    check(slam.db_halvings and slam._kf_stride > cfg.loop.kf_interval,
          "loop DB capacity: the DB never re-tiered")
    check(any(c["frame"] > 12 for c in slam.loop_closures),
          f"loop DB capacity: no closure after frame 12: "
          f"{[(c['frame'], c['keyframe']) for c in slam.loop_closures]}")
    check(ate < 0.03, f"loop DB capacity: ATE {ate} >= 0.03")
    report("loop DB capacity", slam, *run, f"24 frames, 8-slot DB, stride "
           f"now {slam._kf_stride}, ATE {ate:.5f} m (< 0.03)")

    # test_corridor_exploration_closure_gate: 80 frames, off then on.
    n = 80
    cfg = base.replace(loop=LoopClosureConfig(
        enabled=True, kf_interval=4, capacity=32, min_gap=36,
        max_fp_dist=0.3, max_residual=0.03, max_drift_rate=0.08))
    t0 = time.perf_counter()
    frames, gt = _mini_corridor(cfg, n)
    gen_s = time.perf_counter() - t0
    errs = {}
    for on in (False, True):
        c = cfg if on else cfg.replace(loop=LoopClosureConfig(enabled=False))
        slam = SlamSystem(c)
        run = _run_frames(slam, frames, True, counters)
        slam._materialize_poses()
        errs[on] = float(np.linalg.norm(slam.poses[-1][:3, 3]
                                        - gt[-1][:3, 3]))
        name = f"loop corridor mini {'on' if on else 'off'}"
        report(name, slam, *run, f"{n} frames 160x120 (rendered in "
               f"{gen_s:.1f} s), end error {errs[on]:.4f} m")
    t_err = check_closures.t_errors(slam.loop_closures, gt)
    check(len(slam.loop_closures) >= 1, "loop corridor mini: no closure")
    check(all(c["residual"] < cfg.loop.max_residual
              for c in slam.loop_closures) and max(t_err) < 0.5,
          f"loop corridor mini: false closure, T errors {t_err}")
    check(errs[True] < max(0.6 * errs[False], 0.02),
          f"loop corridor mini: end error on {errs[True]} vs off "
          f"{errs[False]}")
    print(f"[loop gates] ok: the three tests/test_keyframes.py pipeline "
          f"gates through the port on {card}; mini corridor end error on "
          f"{errs[True]:.4f} m vs off {errs[False]:.4f} (< max(0.6 x off, "
          f"0.02)), closure T errors "
          f"{', '.join(f'{e:.3f}' for e in t_err)} m (< 0.5)", flush=True)
    return results


def phase_corridor(card, tmp):
    """The production corridor_loop profile, 300 frames, at the
    configuration of ACC_r5_corridor_{off,on}_s0.json (QVGA, F=4, post 2,
    capacity 262144, lambda_reg 1.2, seed 0), loop closure off then on
    (module docstring, phase 10).  The sequence is rendered into
    $SF_ADV_CACHE; the on run's row is written to `tmp` by
    apps/accuracy_bench.py's row code and read back by
    apps/check_closures.py."""
    import dataclasses

    from staticfusion_tpu_torch.apps import accuracy_bench, check_closures
    from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                               LoopClosureConfig, SFConfig)
    from staticfusion_tpu_torch.io import adversarial as adv
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    counters = _counters()
    cfg = SFConfig(camera=CameraConfig(width=320, height=240),
                   fusion=FusionConfig(capacity=1 << 18, index_factor=4,
                                       post_factor=2))
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, lambda_reg=1.2))
    n = CORRIDOR_FRAMES
    t0 = time.perf_counter()
    frames, gt = adv.make_adversarial_sequence(
        cfg, n, "corridor_loop", seed=0, cache_dir=accuracy_bench.cache_dir())
    gen_s = time.perf_counter() - t0
    print(f"[corridor] generator: corridor_loop, {n} frames 320x240, seed "
          f"0, in {gen_s:.1f} s on the host (rendered and cached)",
          flush=True)
    results, ates = {}, {}
    for on in (False, True):
        slam = SlamSystem(cfg.replace(loop=LoopClosureConfig(enabled=on)))
        probs = []
        launches, step_ms, tick_ms, tick_k3, run_s = _run_frames(
            slam, frames, True, counters, probs_out=probs)
        _app_launch_check("corridor", launches, n)
        ates[on] = slam.ate(np.arange(n) / 30.0, gt)
        t_err = check_closures.t_errors(slam.loop_closures, gt)
        false = sum(e > check_closures.FALSE_CLOSURE_M for e in t_err)
        plain, tick = _loop_stats(step_ms, tick_ms)
        name = f"corridor {'on' if on else 'off'}"
        results[name] = {"launches": launches, "ticks": len(tick_ms),
                         "tick_k3": tick_k3}
        print(f"  loop closure {'on' if on else 'off'}: ATE {ates[on]:.5f} "
              f"m, closures {len(slam.loop_closures)} "
              f"(frame<-keyframe {[(c['frame'], c['keyframe']) for c in slam.loop_closures]}), "
              f"false closures (T error > 0.5 m) {false}"
              f"{'' if not t_err else f', T errors {min(t_err):.3f}..{max(t_err):.3f} m'}"
              f", DB halvings {len(slam.db_halvings)}; median {plain:.3f} "
              f"ms/frame over non-tick frames"
              + (f", {tick:.3f} ms per keyframe tick ({len(tick_ms)} ticks, "
                 f"{tick_k3} K3 launches in their closure work, "
                 f"{tick_k3 / max(len(tick_ms), 1):.2f} a tick)"
                 if on else "")
              + f"; K3 launches {launches['irls_solve']}; run {run_s:.1f} "
              f"s; on {card}", flush=True)
        if on:
            closures, on_false = len(slam.loop_closures), false
            row = accuracy_bench.make_row(slam, "corridor_loop", 0, frames,
                                          gt, probs[0])
    check(closures >= 1, "corridor: loop closure on fired no closure")
    check(ates[True] < ates[False], f"corridor: ATE with loop closure "
          f"{ates[True]} m not below without {ates[False]} m")
    path = os.path.join(tmp, "ACC_r5_corridor_on_s0.json")
    with open(path, "w") as f:
        json.dump([row], f, indent=2)
    (summary,) = check_closures.check(path)
    check(summary["closures"] == closures
          and summary["false_closures_gt_0p5m"] == on_false,
          f"corridor: check_closures on the written row {summary} against "
          f"{closures} closures, {on_false} false")
    check(row["ate_rmse_m"] == round(float(ates[True]), 5),
          f"corridor: the row's ATE {row['ate_rmse_m']} is not the run's")
    print(f"[corridor] ok: ATE on {ates[True]:.5f} m < off "
          f"{ates[False]:.5f} m with {closures} closures on {card}; the on "
          f"row (accuracy_bench) has IoU {row['seg_iou']}, RPE "
          f"{row['rpe_rmse_m']} m, and check_closures reads {summary} back "
          f"from it.  The JAX "
          f"package's committed run of this configuration (accuracy, not a "
          f"gate; it ran with fixed tiers, which the port does not have): "
          f"on 1.702 m, off 1.894 m, 8 closures, 1 false "
          f"(ACC_r5_corridor_{{on,off}}_s0.json)", flush=True)
    return results


def _paced_stream(frames, hz):
    """A producer thread writes `frames` with the port's SFRD writer onto
    one end of a socket pair at `hz`, each stamped with time.time() as it
    is sent.  -> (reader file, reader socket, thread, stamps, errors)."""
    import socket
    import threading

    from staticfusion_tpu_torch.io import stream
    a, b = socket.socketpair()
    a.settimeout(LIVE_TIMEOUT)
    b.settimeout(LIVE_TIMEOUT)
    fa, fb = a.makefile("wb"), b.makefile("rb")
    stamps, errors = [], []
    rows, cols = frames[0][1].shape

    def produce():
        try:
            stream.write_stream_header(fa, cols, rows)
            fa.flush()
            t0 = time.time()
            for i, (rgb, depth_mm, _) in enumerate(frames):
                delay = t0 + i / hz - time.time()
                if delay > 0:
                    time.sleep(delay)
                stamps.append(time.time())
                stream.write_frame(fa, rgb, depth_mm, stamps[-1])
                fa.flush()
            stream.write_stream_end(fa)
            fa.flush()
        except OSError as e:
            errors.append(e)
        finally:
            fa.close()
            a.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    return fb, b, t, stamps, errors


def _camera_run(frames, gt, latest_only, counters):
    """run_camera's loop on the card over a paced socket stream of
    `frames`: -> (slam, source, latencies s, launches, stamps, seconds).
    The launch counts are set to 0 before the run."""
    import torch

    from staticfusion_tpu_torch.apps import run_camera
    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.io.stream import StreamSource
    from staticfusion_tpu_torch.pipeline.system import SlamSystem
    slam = SlamSystem(SFConfig())
    for fn in counters.values():
        fn.launches = 0
    fb, sock, t, stamps, errors = _paced_stream(frames, LIVE_HZ)
    try:
        # The synthetic world's back wall sits at the sensor's 3 m gate, so
        # the range gate is lifted as in tests/test_stream.py.
        src = StreamSource(fb, latest_only=latest_only, max_distance_m=100.0)
        t0 = time.perf_counter()
        lat = run_camera.run_loop(slam, src, log_every=20)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        t.join(LIVE_TIMEOUT)
    finally:
        fb.close()
        sock.close()
    check(not t.is_alive(), "live: the producer thread did not finish")
    check(not errors, f"live: the producer failed: {errors}")
    check(len(stamps) == len(frames), f"live: {len(stamps)} frames sent")
    return (slam, src, lat, {k: fn.launches for k, fn in counters.items()},
            stamps, run_s)


def _fetch(base, path):
    return urllib.request.urlopen(base + path, timeout=5).read()


def phase_live(card, main_run, data, app_wall_med):
    """The live path and the viewers on the card (phase 11 of the module
    docstring).  Returns {run: {"launches": ...}}."""
    import torch

    from staticfusion_tpu_torch.apps import run_camera, run_sequence
    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.fusion import texelmap
    from staticfusion_tpu_torch.fusion.surfels import SurfelMap
    from staticfusion_tpu_torch.io import native
    from staticfusion_tpu_torch.io.ply import load_ply_count
    from staticfusion_tpu_torch.viz.render import MODES, colorize, render_view
    t_phase = time.perf_counter()
    counters = _counters()
    cfg = SFConfig()
    n = LIVE_FRAMES
    source = run_camera.SyntheticSource(cfg, n)
    frames, gt = source.frames, source.gt
    results = {}

    # (a) run_camera over a paced stream: replay, then drop-to-latest.
    slam, src, lat, launches, stamps, run_s = _camera_run(frames, gt, False,
                                                          counters)
    _app_launch_check("live replay", launches, n)
    ate = slam.ate(np.asarray(stamps), gt)
    check(len(slam.poses) == n - 1, f"live replay: {len(slam.poses)} poses")
    check(np.isfinite(ate) and ate < ATE_LIMIT,
          f"live replay: ATE {ate} m >= {ATE_LIMIT}")
    ms = 1e3 * np.asarray(lat)
    print(f"[live] replay: run_camera over a {LIVE_HZ:.0f} Hz socket stream "
          f"of {n} QVGA frames (F=4 post 2): {len(slam.poses)} poses, ATE "
          f"{ate:.5f} m (< {ATE_LIMIT}); capture->pose latency median "
          f"{np.median(ms):.3f} ms, p90 {np.quantile(ms, 0.9):.3f} ms "
          f"(frames queue: replay delivers every frame); run {run_s:.2f} s "
          f"({1e3 * run_s / n:.3f} ms/frame); launches K1 "
          f"{launches['preprocess_depth']}, K3 {launches['irls_solve']}, K2 "
          f"{launches['spd_solve']}; on {card}", flush=True)
    results["live replay"] = {"launches": launches}

    slam, src, lat, launches, stamps, run_s = _camera_run(frames, gt, True,
                                                          counters)
    delivered = len(lat)
    check(src.received == n, f"live: {src.received} frames received")
    check(delivered + src.dropped == src.received,
          f"live: delivered {delivered} + dropped {src.dropped} != "
          f"received {src.received}")
    check(delivered >= 2, f"live: {delivered} frames delivered")
    _app_launch_check("live drop-to-latest", launches, delivered)
    slam._materialize_poses()
    check(all(np.isfinite(p).all() for p in slam.poses),
          "live: non-finite pose")
    ate = slam.ate(np.asarray(stamps), gt)
    ms = 1e3 * np.asarray(lat)
    print(f"  drop-to-latest: received {src.received}, delivered "
          f"{delivered}, dropped {src.dropped}; capture->pose latency "
          f"median {np.median(ms):.3f} ms, p90 {np.quantile(ms, 0.9):.3f} "
          f"ms; ATE over the delivered frames {ate:.5f} m (not gated); run "
          f"{run_s:.2f} s; launches K1 {launches['preprocess_depth']}, K3 "
          f"{launches['irls_solve']}", flush=True)
    results["live drop-to-latest"] = {"launches": launches}

    # (b) render_view of the main path's final map, card vs CPU.
    main_slam = main_run[0]
    smap, pose = main_slam.state.smap, main_slam.state.curr_pose
    smap_c = SurfelMap(*(t.cpu() for t in smap))
    thr = cfg.fusion.confidence_threshold
    view_g = render_view(smap, pose, thr, cfg)
    view_c = render_view(smap_c, pose.cpu(), thr, cfg)
    winners = [texelmap.render_texel_images(
        m, texelmap.project_surfels(m, p, cfg),
        torch.zeros((), dtype=torch.int32, device=p.device), cfg,
        conf_threshold=thr, z_min=cfg.fusion.predict_z_min,
        time_delta=float("inf")).idx.cpu()
        for m, p in ((smap, pose), (smap_c, pose.cpu()))]
    n_winners = int((winners[0] != winners[1]).sum())
    hit_g, hit_c = view_g.depth.cpu() > 0, view_c.depth > 0
    agree = float((hit_g == hit_c).float().mean())
    both = (hit_g & hit_c).numpy()
    diffs = {}
    for mode in MODES:
        a = colorize(view_g, mode, cfg).astype(np.int32)
        b = colorize(view_c, mode, cfg).astype(np.int32)
        diffs[mode] = np.abs(a - b).max(axis=-1)[both]
    rgb_ok = float(np.mean(diffs["rgb"] <= RENDER_RGB_TOL))
    check(n_winners == 0, f"render: {n_winners} texel winners differ "
          "between card and CPU")
    check(agree >= RENDER_HIT_AGREE, f"render: hit masks agree at "
          f"{agree:.5f} < {RENDER_HIT_AGREE} of pixels")
    check(rgb_ok >= RENDER_RGB_SHARE, f"render: rgb within "
          f"{RENDER_RGB_TOL}/255 at {rgb_ok:.6f} < {RENDER_RGB_SHARE} of "
          f"common hits")
    render_ms = cuda_ms(lambda: render_view(smap, pose, thr, cfg),
                        RENDER_REPS)
    print(f"  render_view of the main path's final map "
          f"({int(smap.count())} surfels, {smap.capacity} slots) at its "
          f"final pose, conf >= {thr}: card vs CPU identical texel "
          f"winners ({winners[0].numel()} texels), hit masks agree at "
          f"{agree:.5f} of pixels ({float(hit_g.float().mean()):.4f} hit), "
          f"rgb within {RENDER_RGB_TOL}/255 at {rgb_ok:.6f} of "
          f"{int(both.sum())} common hits; max |diff| (/255) and pixels "
          f"over {RENDER_RGB_TOL}/255 by mode: "
          + ", ".join(f"{m} {int(d.max()) if d.size else 0} "
                      f"({int((d > RENDER_RGB_TOL).sum())})"
                      for m, d in diffs.items())
          + f"; {render_ms:.3f} ms per render_view on the card (CUDA "
          f"events, mean over {RENDER_REPS})", flush=True)

    # (c) run_sequence with the three viewer flags over the app dataset.
    tmp = os.path.dirname(data)
    out = {k: os.path.join(tmp, v) for k, v in (
        ("html", "live.html"), ("viz", "panels"), ("ply", "live.ply"),
        ("traj", "live.txt"))}
    viewers = []
    try:
        launches, _, wall, run_s = _app_run(
            [lambda a: viewers.append(run_sequence.main(a)), data,
             "--res-factor", "2", "--depth-scale", "5000", "--html",
             out["html"], "--viz", out["viz"], "--live", "0",
             "--live-every", "5", "--ply", out["ply"], "--out",
             out["traj"], "--metrics", os.devnull], counters)
        viewer = viewers[0]
        check(viewer is not None, "live: run_sequence --live returned no "
              "viewer")
        base = f"http://127.0.0.1:{viewer.port}"
        png = _fetch(base, "/frame.png")
        met = json.loads(_fetch(base, "/metrics.json"))
        params = json.loads(_fetch(base, "/params.json"))
    finally:
        for v in viewers:
            if v is not None:
                v.close()
    napp = APP_FRAMES
    _app_launch_check("live run_sequence", launches, napp)
    check(png[:8] == b"\x89PNG\r\n\x1a\n", "live: /frame.png is no PNG")
    last = (napp - 1) // 5 * 5     # the last frame the view refreshed on
    check(met.get("frame", -1) >= last and met.get("surfels", 0) > 0,
          f"live: /metrics.json {met}, expected frame >= {last}")
    check(params == {"conf": cfg.fusion.confidence_threshold,
                     "depth": cfg.fusion.depth_max, "pause": False},
          f"live: /params.json {params}")
    html = open(out["html"]).read()
    start = html.index("const DATA = ") + len("const DATA = ")
    page = json.loads(html[start:html.index(";\n", start)])
    n_pts = len(base64.b64decode(page["pos"])) // 12
    n_traj = [len(base64.b64decode(t["pts"])) // 12 for t in page["trajs"]]
    n_ply = load_ply_count(out["ply"])
    check(n_pts == n_ply > 0, f"live: the page has {n_pts} points, the "
          f"PLY {n_ply}")
    check(n_traj == [napp - 1, napp], f"live: trajectories of {n_traj} "
          f"points, expected [{napp - 1}, {napp}]")
    names = sorted(os.listdir(out["viz"]))
    check(names == [f"frame_{i:05d}.png" for i in range(1, napp)],
          f"live: panel files {names[:3]}..., expected frames 1..{napp - 1}")
    for name in names:
        img = native.decode_png(os.path.join(out["viz"], name))
        check(img is not None and img.shape == (2 * cfg.rows, 2 * cfg.cols,
                                                3) and img.dtype == np.uint8,
              f"live: {name} decodes to "
              f"{None if img is None else (img.shape, img.dtype)}")
    wall_med = float(np.median(wall[1:]))
    print(f"  run_sequence --html --viz --live 0 --live-every 5 (QVGA, "
          f"--res-factor 2): page with {n_pts} points (= the PLY's) and "
          f"trajectories of {n_traj[0]} and {n_traj[1]} poses; "
          f"{len(names)} panel PNGs of {2 * cfg.rows}x{2 * cfg.cols}, each "
          f"read back by the native decoder; after the run /frame.png "
          f"({len(png)} bytes), /metrics.json (frame {met['frame']}, "
          f"surfels {met['surfels']}) and /params.json answer; app wall "
          f"median {wall_med:.3f} ms/frame (run_tum in the app phase "
          f"{app_wall_med:.3f}); run {run_s:.2f} s; launches K1 "
          f"{launches['preprocess_depth']}, K3 {launches['irls_solve']}",
          flush=True)
    results["live run_sequence"] = {"launches": launches}
    print(f"[live] ok: run_camera replay and drop-to-latest, render card vs "
          f"CPU, run_sequence's viewer flags in "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return results


def _gloo_probe():
    """Which collectives ProcessGroupGloo accepts on CUDA tensors: two
    threads, each a rank of one group over a HashStore, try all-reduce
    SUM/MIN/MAX and all-gather on float32 and int64 tensors on the card,
    then time a MIN all-reduce of the F=4 QVGA z-buffer (1228800 int64)
    on the card and staged through host copies (mean of 5 after 1).
    -> ({case: "ok" / "wrong" / the error's first line}, {way: ms})."""
    import threading
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    store = dist.HashStore()
    cases = [(op, dt) for op in ("sum", "min", "max", "gather")
             for dt in (torch.float32, torch.int64)]
    verdicts, times = [{}, {}], [{}, {}]

    def rank(r):
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timedelta(seconds=20)
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        pg = dist.ProcessGroupGloo(dist.PrefixStore("probe", store), r, 2,
                                   opts)
        for op, dt in cases:
            x = torch.tensor([3 * r + 1, 5 - r], dtype=dt, device="cuda")
            try:
                if op == "gather":
                    outs = [torch.empty_like(x) for _ in range(2)]
                    pg.allgather([outs], [x]).wait()
                    got = torch.cat(outs).cpu().tolist()
                    want = [1, 5, 4, 4]
                else:
                    o = dist.AllreduceOptions()
                    o.reduceOp = {"sum": dist.ReduceOp.SUM,
                                  "min": dist.ReduceOp.MIN,
                                  "max": dist.ReduceOp.MAX}[op]
                    pg.allreduce([x], o).wait()
                    torch.cuda.synchronize()
                    got = x.cpu().tolist()
                    want = {"sum": [5, 9], "min": [1, 4],
                            "max": [4, 5]}[op]
                verdicts[r][f"{op} {str(dt)[6:]}"] = (
                    "ok" if got == want else f"wrong {got}")
            except RuntimeError as e:
                verdicts[r][f"{op} {str(dt)[6:]}"] = str(e).splitlines()[0]
        o = dist.AllreduceOptions()
        o.reduceOp = dist.ReduceOp.MIN
        z = torch.arange(1228800, dtype=torch.int64, device="cuda") * (r + 1)
        for way in ("on the card", "staged"):
            for rep in range(6):
                if rep == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                if way == "staged":
                    buf = z.cpu()
                    pg.allreduce([buf], o).wait()
                    buf.to("cuda")
                else:
                    pg.allreduce([z.clone()], o).wait()
            torch.cuda.synchronize()
            times[r][way] = 1e3 * (time.perf_counter() - t0) / 5

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    check(not any(t.is_alive() for t in threads), "gloo probe: a rank hung")
    return verdicts[0], times[0]


def _rank_runs(argv, n, tmp, tag):
    """n run_multihost worker processes on the card over a FileStore in
    `tmp` -> [(POSE dict, STATS dict)] by rank.  Each is killed after
    PAR_TIMEOUT s."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "staticfusion_tpu_torch.apps.run_multihost",
            "--store", os.path.join(tmp, f"store_{tag}"),
            "--num-processes", str(n)] + argv
    procs = [subprocess.Popen(base + ["--process-id", str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=here) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAR_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    runs = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"{tag}: rank {i} exited {p.returncode}:\n{out[-3000:]}")
        poses, stats = {}, None
        for line in out.splitlines():
            if line.startswith("POSE "):
                k, *v = line[5:].split()
                poses[int(k)] = np.asarray([float(x) for x in v]).reshape(4,
                                                                          4)
            elif line.startswith("STATS "):
                stats = json.loads(line[6:])
        check(stats is not None, f"{tag}: rank {i} printed no STATS")
        runs.append((poses, stats))
    return runs


def _graph_on_card(n_poses):
    """A drifted odometry chain of n_poses on the card with 2 n_poses
    constraints: the chain, loops back to pose 0 every 8 poses, padding."""
    import torch

    from staticfusion_tpu_torch.geometry.se3 import se3_exp
    from staticfusion_tpu_torch.parallel import posegraph as pg
    rng = np.random.default_rng(7)
    g = pg.empty_graph(n_poses, 2 * n_poses, device="cuda")
    exp = lambda x: se3_exp(torch.as_tensor(x, dtype=torch.float32,
                                            device="cuda"))
    gt = [torch.eye(4, device="cuda")]
    for _ in range(n_poses - 1):
        gt.append(gt[-1] @ exp(0.05 * rng.normal(size=6)))
    drift = exp([0.004, 0.0, -0.003, 0.001, 0.0015, 0.0])
    pose = gt[0]
    for k in range(n_poses):
        g = pg.add_pose(g, pose)
        if k + 1 < n_poses:
            T = torch.linalg.inv(gt[k]) @ gt[k + 1]
            g = pg.add_constraint(g, k, k + 1, T @ drift)
            pose = pose @ T @ drift
    for k in range(8, n_poses, 8):
        g = pg.add_constraint(g, 0, k, torch.linalg.inv(gt[0]) @ gt[k], 8.0)
    return g


def phase_parallel(card):
    """The multi-device layer on the card (phase 12 of the module
    docstring).  Returns {run: {"launches": ...}}."""
    import threading
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                               SFConfig)
    from staticfusion_tpu_torch.io import synthetic
    from staticfusion_tpu_torch.parallel import mesh as mesh_lib
    from staticfusion_tpu_torch.parallel import posegraph as pg
    from staticfusion_tpu_torch.pipeline.step import (Frame, bootstrap_step,
                                                      slam_step)
    t_phase = time.perf_counter()
    counters = _counters()
    results = {}

    probe, probe_ms = _gloo_probe()
    print("[parallel] Gloo on CUDA tensors: " + ", ".join(
        f"{k} {v}" for k, v in probe.items()) + "; MIN of 1228800 int64: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in probe_ms.items()),
        flush=True)
    # The helpers hand Gloo the CUDA tensors of these pairs unstaged.
    for op, dt in mesh_lib.GLOO_CUDA:
        check(probe[f"{op} {str(dt)[6:]}"] == "ok",
              f"Gloo refuses {op} on CUDA {dt}, which mesh.GLOO_CUDA lists")

    # One process on the card, no tiers (the sharded runs keep the
    # bootstrap's capacity): the reference of every mesh.
    cfg = SFConfig(camera=CameraConfig(width=320, height=240),
                   fusion=FusionConfig(capacity=PAR_CAPACITY))
    frames, gt = synthetic.make_sequence(cfg, PAR_FRAMES, TWIST)
    dev = lambda i: Frame(*[torch.as_tensor(a, device="cuda")
                            for a in frames[i][:2]])
    for fn in counters.values():
        fn.launches = 0
    ref_poses, ms_ref = {}, []
    for i in range(1, PAR_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 1:
            state, out = bootstrap_step(dev(0), dev(1),
                                        torch.eye(4, device="cuda"), cfg)
        else:
            state, out = slam_step(state, dev(i), cfg)
        torch.cuda.synchronize()
        ms_ref.append(1e3 * (time.perf_counter() - t0))
        ref_poses[i] = out.curr_pose.cpu().numpy()
    ref_launches = {k: fn.launches for k, fn in counters.items()}
    ref_count = int(out.surfel_count)
    ref_med = float(np.median(ms_ref[2:]))
    print(f"[parallel] one process: {PAR_FRAMES} frames QVGA F=4 post 2 at "
          f"capacity {state.smap.capacity} (no tiers): surfels {ref_count}, "
          f"launches {ref_launches}, median {ref_med:.1f} ms/frame over "
          f"frames 3..{PAR_FRAMES - 1}", flush=True)

    argv = ["--frames", str(PAR_FRAMES), "--width", "320", "--height", "240",
            "--capacity", str(PAR_CAPACITY), "--device", "cuda"]
    with tempfile.TemporaryDirectory(prefix="sf_parallel_") as tmp:
        for n_pix, n_map in PAR_MESHES:
            tag = f"parallel {n_pix}x{n_map}"
            t0 = time.perf_counter()
            runs = _rank_runs(argv + ["--n-pix", str(n_pix), "--n-map",
                                      str(n_map)], n_pix * n_map, tmp,
                              f"{n_pix}x{n_map}")
            run_s = time.perf_counter() - t0
            total = {}
            for r, (poses, st) in enumerate(runs):
                check(sorted(poses) == sorted(ref_poses),
                      f"{tag}: rank {r} posed frames {sorted(poses)}")
                check(st["device"].startswith("cuda"),
                      f"{tag}: rank {r} state on {st['device']}")
                rank_d = max(float(np.abs(poses[k] - runs[0][0][k]).max())
                             for k in poses)
                check(rank_d <= PAR_RANK_TOL,
                      f"{tag}: rank {r} differs from rank 0 by {rank_d}")
                first = float(np.abs(poses[2] - ref_poses[2]).max())
                worst = max(float(np.abs(poses[k] - ref_poses[k]).max())
                            for k in poses)
                check(first <= PAR_FIRST_TOL,
                      f"{tag}: first step differs by {first}")
                check(worst <= PAR_POSE_TOL,
                      f"{tag}: a pose differs by {worst}")
                dc = abs(st["surfels_total"] - ref_count) / ref_count
                check(dc <= PAR_COUNT_TOL,
                      f"{tag}: surfels {st['surfels_total']} vs {ref_count}")
                la = st["launches"]
                check(la["preprocess_depth"] == PAR_FRAMES - 1,
                      f"{tag}: rank {r} K1 launched "
                      f"{la['preprocess_depth']} times")
                check(la["irls_solve"] == ref_launches["irls_solve"],
                      f"{tag}: rank {r} K3 launched {la['irls_solve']} times "
                      f"vs {ref_launches['irls_solve']} in one process: a "
                      "solve did not run K3")
                check(la["spd_solve"] == 0 and la["spd_inverse"] == 0,
                      f"{tag}: rank {r} K2 launched standalone: {la}")
                for k, v in la.items():
                    total[k] = total.get(k, 0) + v
                med = float(np.median(st["ms_per_frame"][3:]))
                comm = ", ".join(f"{h} {c} calls {b / 1e6:.2f} MB"
                                 for h, (c, b) in st["comm"].items())
                print(f"  {tag} rank {r} (pix {st['pix']}, map {st['map']})"
                      f": slots [{st['slots'][0]}, {st['slots'][1]}) holding "
                      f"{st['surfels']} surfels of {st['surfels_total']}, "
                      f"rows [{st['rows'][0]}, {st['rows'][1]}) = "
                      f"{st['pixels']} pixels; K1 {la['preprocess_depth']}, "
                      f"K3 {la['irls_solve']} launches; {comm}; median "
                      f"{med:.1f} ms/frame vs {ref_med:.1f} in one process; "
                      f"first step {first:.3e}, worst pose {worst:.3e}",
                      flush=True)
                print(f"    work {st['work']}", flush=True)
            results[tag] = {"launches": total}
            print(f"[parallel] ok: {tag} on {card}: {n_pix * n_map} rank "
                  f"processes on cuda:0 over Gloo, {run_s:.1f} s", flush=True)

        # The launcher's own spawn mode, once.
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "staticfusion_tpu_torch.apps.run_multihost",
             "--spawn", "2"], capture_output=True, text=True, env=env,
            cwd=here, timeout=PAR_TIMEOUT)
        out = p.stdout + p.stderr
        check(p.returncode == 0 and "FINAL err_vs_gt=" in out
              and "proc 0/2:" in out,
              f"run_multihost --spawn 2 exited {p.returncode}:\n"
              f"{out[-3000:]}")
        final = [l for l in out.splitlines() if l.startswith("FINAL")][0]
        print(f"[parallel] ok: run_multihost --spawn 2 on the card in "
              f"{time.perf_counter() - t0:.1f} s: {final}", flush=True)

    # optimize_sharded on 2 ranks (threads of this process on the card)
    # against the dense optimize.
    g = _graph_on_card(PAR_GRAPH_POSES)
    dense = pg.optimize(g, iters=8).poses
    store = dist.HashStore()
    got, errors = {}, {}

    def rank(r):
        try:
            mesh = mesh_lib.make_mesh(1, 2, r, store, timedelta(seconds=60),
                                      device="cuda")
            got[r] = (pg.optimize_sharded(g, mesh, iters=8).poses, mesh)
        except RuntimeError as e:
            errors[r] = e

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"optimize_sharded: ranks failed or hung: {errors}")
    for r, (poses, mesh) in got.items():
        d = float((poses - dense).abs().max())
        check(d <= PAR_GRAPH_TOL,
              f"optimize_sharded: rank {r} differs from optimize by {d}")
        (_, C), n = next(iter(mesh.work.items()))
        print(f"  optimize_sharded rank {r}: {n} of {C} constraints, "
              f"|poses - optimize| {d:.3e}, {mesh.comm}", flush=True)
    print(f"[parallel] ok: meshes {PAR_MESHES}, the launcher and "
          f"optimize_sharded ({PAR_GRAPH_POSES} poses, 2 ranks) in "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return results


def _launched(counters, fn):
    """fn() with the launch counts set to 0 before it: -> (its result,
    launches, seconds to a synchronize after it)."""
    import torch
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: c.launches for k, c in counters.items()},
            time.perf_counter() - t0)


def _per_frame(launches, n):
    return ", ".join(f"{k} {v / n:.3f}" for k, v in launches.items())


def phase_tools(card, tmp):
    """The evaluation tools of staticfusion_tpu_torch/apps on the card
    (phase 13 of the module docstring), writing into `tmp`.  Returns
    {run: {"launches": ...}}."""
    import socket

    from staticfusion_tpu_torch.apps import (accuracy_bench, calibrate_loop,
                                             run_camera, smoke_e2e)
    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.io import synthetic
    from staticfusion_tpu_torch.io.trajectory import (ate_rmse,
                                                      read_tum_trajectory)
    t_phase = time.perf_counter()
    counters = _counters()
    results = {}

    # (a) accuracy_bench.main on the card.
    n = TOOLS_FRAMES
    path = os.path.join(tmp, "ACC_tools_walk_s1.json")
    rows, launches, run_s = _launched(counters, lambda: accuracy_bench.main(
        ["--profiles", "walk_xyz", "--factors", "4", "--frames", str(n),
         "--seed", "1", "--json", path]))
    (row,) = rows
    with open(path) as f:
        check(json.load(f) == rows, "tools: accuracy_bench's JSON is not "
              "its rows")
    check(tuple(row) == JAX_ROW_KEYS, f"tools: row keys {tuple(row)}")
    check(row["fixed_tiers"] is False, "tools: fixed_tiers is not false")
    check(row["ate_rmse_m"] < 0.05 and row["seg_iou"] is not None
          and row["seg_iou"] > 0.55, f"tools: walk_xyz F=4 seed 1 ATE "
          f"{row['ate_rmse_m']} (< 0.05), IoU {row['seg_iou']} (> 0.55)")
    check(n - 1 <= launches["preprocess_depth"] <= n
          and 4.0 <= launches["irls_solve"] / n <= 6.0
          and launches["spd_solve"] == launches["spd_inverse"] == 0,
          f"tools: accuracy_bench launches {launches}")
    results["tools accuracy_bench"] = {"launches": launches}
    print(f"  (a) accuracy_bench walk_xyz F=4, {n} frames, seed 1: ATE "
          f"{row['ate_rmse_m']} m (< 0.05), RPE {row['rpe_rmse_m']} m, IoU "
          f"{row['seg_iou']} (> 0.55), fps {row['fps']} (host dispatch, "
          f"not a speed), keys = the JAX tool's, fixed_tiers false; run "
          f"{run_s:.1f} s (rendering included); launches per frame: "
          f"{_per_frame(launches, n)}", flush=True)

    # (c) stream_feed in a process of its own feeds run_camera here.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    traj = os.path.join(tmp, "live_trajectory.txt")
    feeder = subprocess.Popen(
        [sys.executable, "-m", "staticfusion_tpu_torch.apps.stream_feed",
         "--to", f"tcp://127.0.0.1:{port}", "--frames", str(LIVE_FRAMES),
         "--fps", str(LIVE_HZ)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, launches, run_s = _launched(counters, lambda: run_camera.main(
            ["--source", f"listen://{port}", "--replay", "--out", traj]))
        out, err = feeder.communicate(timeout=LIVE_TIMEOUT)
    finally:
        if feeder.poll() is None:
            feeder.kill()
        feeder.wait(LIVE_TIMEOUT)
    check(feeder.returncode == 0, f"tools: stream_feed exited "
          f"{feeder.returncode}: {err[-2000:]}")
    check(f"streamed {LIVE_FRAMES} frames" in out, f"tools: stream_feed "
          f"said {out!r}")
    times, poses = read_tum_trajectory(traj)
    _, gt = synthetic.make_sequence(SFConfig(), LIVE_FRAMES, run_camera.TWIST)
    check(len(times) == LIVE_FRAMES - 1, f"tools: run_camera wrote "
          f"{len(times)} poses, not {LIVE_FRAMES - 1}")
    # The trajectory holds frames 1..59 in order, stamped by the feeder.
    ate = ate_rmse(times, poses, times, gt[1:])
    check(ate < ATE_LIMIT, f"tools: stream_feed -> run_camera ATE {ate}")
    results["tools stream_feed->run_camera"] = {"launches": launches}
    print(f"  (c) stream_feed (a separate process, tcp://127.0.0.1:{port} "
          f"at {LIVE_HZ:g} Hz) -> run_camera --source listen://{port} "
          f"--replay: {len(times)} poses, ATE {ate:.5f} m (< {ATE_LIMIT}); "
          f"run {run_s:.1f} s; launches per frame: "
          f"{_per_frame(launches, LIVE_FRAMES)}", flush=True)

    # (d) smoke_e2e on the card.
    res, launches, run_s = _launched(counters, lambda: smoke_e2e.main([]))
    check(res["ate"] < ATE_LIMIT, f"tools: smoke_e2e ATE {res['ate']}")
    results["tools smoke_e2e"] = {"launches": launches}
    print(f"  (d) smoke_e2e: ATE {res['ate']:.5f} m (< {ATE_LIMIT}); run "
          f"{run_s:.1f} s; launches {launches}", flush=True)

    # (e) calibrate_loop's populations, card against CPU.
    (pos, neg), launches, run_s = _launched(
        counters, lambda: calibrate_loop.populations("cuda"))
    pos_h, neg_h = calibrate_loop.populations("cpu")
    pairs = list(zip(pos + neg, pos_h + neg_h))
    worst_fp = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in pairs)
    worst_r = max(0.0 if a[1] == b[1] else abs(a[1] - b[1])
                  for a, b in pairs)
    for tag, card_p, cpu_p in (("POS", pos, pos_h), ("NEG", neg, neg_h)):
        for (fp, r), (fp_h, r_h) in zip(card_p, cpu_p):
            print(f"      {tag} fp_dist {fp:.6e} (CPU {fp_h:.6e}), "
                  f"residual {r:.6f} (CPU {r_h:.6f})", flush=True)
    check(worst_fp <= CALIB_RTOL and worst_r <= CALIB_RESID_ATOL,
          f"tools: calibrate_loop card vs CPU: fp_dist {worst_fp:.3e} "
          f"relative (> {CALIB_RTOL}?), residual {worst_r:.3e} m (> "
          f"{CALIB_RESID_ATOL}?)")
    results["tools calibrate_loop"] = {"launches": launches}
    print(f"  (e) calibrate_loop: {len(pos)} positive and {len(neg)} negative "
          f"pairs, card vs CPU: fp_dist within {worst_fp:.3e} relative (<= "
          f"{CALIB_RTOL}), residual within {worst_r:.3e} m (<= "
          f"{CALIB_RESID_ATOL}); run {run_s:.1f} s on the card; launches "
          f"{launches}", flush=True)
    print(f"[tools] ok: accuracy_bench, stream_feed -> run_camera, "
          f"smoke_e2e and calibrate_loop on {card} (check_closures ran in "
          f"the corridor phase); phase {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)
    return results


def main() -> int:
    t_start = time.perf_counter()
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
        k3, k3_systems = phase_k3()
        launches, main_run = phase_main(card)
        phase_cross()
        gates = phase_gates(card)
        # The adversarial sequences of the corridor and tools phases are
        # rendered into a cache of this run's own.
        adv_cache = tempfile.TemporaryDirectory(prefix="sf_adv_")
        os.environ["SF_ADV_CACHE"] = adv_cache.name
        with tempfile.TemporaryDirectory(prefix="sf_app_") as app_tmp:
            app, app_data, app_wall = phase_app(card, app_tmp)
            gates.update({k: {"launches": v} for k, v in app.items()})
            gates.update(phase_branches(card))
            gates.update(phase_loop_gates(card))
            corridor = phase_corridor(card, app_tmp)
            gates.update(corridor)
            on = corridor["corridor on"]
            k3["launches_per_keyframe_tick"] = (on["tick_k3"]
                                                / max(on["ticks"], 1))
            gates.update(phase_live(card, main_run, app_data, app_wall))
        gates.update(phase_parallel(card))
        with tempfile.TemporaryDirectory(prefix="sf_tools_") as tools_tmp:
            gates.update(phase_tools(card, tools_tmp))
        adv_cache.cleanup()
        phase_profile(k1, k3, k3_systems, main_run)
    except (SmokeError, AssertionError, RuntimeError, ValueError,
            OSError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    csrc = "staticfusion_tpu_torch/csrc/"
    pallas = "staticfusion_tpu/kernels/"
    rows = [("preprocess_depth", "bilateral.cu",
             "bilateral_pallas.py:117", k1),
            ("spd_solve", "smallsolve.cu", "smallsolve_pallas.py:75", k2s),
            ("spd_inverse", "smallsolve.cu", "smallsolve_pallas.py:93", k2i),
            ("irls_solve", "irls.cu", "irls_pallas.py:242", k3)]
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + src,
         "replaces": pallas + rep, "launches": launches[name], **m,
         "launches_by_gate": {g: r["launches"][name]
                              for g, r in gates.items()}}
        for name, src, rep, m in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
