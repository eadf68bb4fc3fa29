"""K3 wrapper: the coupled IRLS loop, its covariance inverse and the
motion filter of its twist as one cooperative kernel launch per solve
(csrc/irls.cu).

Plain versions: `solve_irls_xla`, then `motion_filter` (solver/irls.py,
re-exported here).  `solve_irls_cuda.launches` counts solves; each solve
is one launch.  The inputs are read where the solver left them: nothing is
copied, cast or reduced on the host side of the launch.
"""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.config import NUM_CLUSTERS, SFConfig
from staticfusion_tpu_torch.kernels import _build
from staticfusion_tpu_torch.solver.irls import (IRLSResult,  # noqa: F401
                                                JacobianSystem,
                                                motion_filter,
                                                motion_filter_weights,
                                                solve_irls_xla)
from staticfusion_tpu_torch.solver.segmentation import SegPrior

TILE = 2048  # pixels per tile (256 threads x 8 pixels)
# Per-tile partials: prologue (2), pass 0 (27), pass 1 (K + 1).
_PARTIALS = 2 + 27 + NUM_CLUSTERS + 1
# Flat output, the OUT_* offsets of csrc/irls.cu: twist 6, b_segm 24,
# aver_res, res_sq, est_cov 36 (row-major), iterations run, the
# motion-filtered twist 6.
OUT_TWIST, OUT_BSEGM, OUT_AVER, OUT_RESSQ, OUT_COV, OUT_ITERS, OUT_FILT = (
    0, 6, 30, 31, 32, 68, 69)
OUT_SIZE = OUT_FILT + 6

_max_blocks: dict = {}  # device index -> co-resident block cap


def launch_plan(n: int, max_blocks: int) -> tuple:
    """(tiles, grid, scratch floats) of one solve over n pixels when at
    most `max_blocks` blocks can be co-resident.  Each block walks tiles
    b, b + grid, ..., and every partial belongs to a tile, so the sums do
    not depend on the grid."""
    if n < 1 or max_blocks < 1:
        raise ValueError(f"launch_plan: n={n}, max_blocks={max_blocks}")
    tiles = -(-n // TILE)
    return tiles, min(tiles, max_blocks), tiles * _PARTIALS


def _coresident_blocks(lib, dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _max_blocks:
        got = lib.sf_irls_max_blocks(idx)
        if got <= 0:
            why = f"CUDA error {-got}" if got else "no cooperative launch"
            raise RuntimeError(f"cuda:{idx} cannot run the cooperative IRLS "
                               f"kernel ({why})")
        _max_blocks[idx] = got
    return _max_blocks[idx]


def irls_solve_flat(sys: JacobianSystem, b_segm0: torch.Tensor,
                    prior: SegPrior, reg_ata: torch.Tensor, config: SFConfig,
                    kb=None, twist_old=None, accumulated_twist=None,
                    level: int = 0) -> torch.Tensor:
    """One launch; returns the flat (OUT_SIZE,) output.  `kb` may be a
    float or a float32 device scalar.  Given `twist_old` and
    `accumulated_twist` ((6,) each), the launch also runs the motion
    filter of `level` on the solved twist; without them OUT_FILT holds the
    twist itself."""
    s = config.solver
    k = NUM_CLUSTERS
    n = sys.B_c.shape[0]
    if n == 0:
        raise ValueError("empty Jacobian system")
    if s.max_iter_irls < 1:
        raise ValueError("max_iter_irls must be >= 1")
    f32 = torch.float32
    dev = sys.B_c.device
    inputs = ((sys.A_cT, "A_cT", f32, (6, n)), (sys.A_dT, "A_dT", f32, (6, n)),
              (sys.B_c, "B_c", f32, (n,)), (sys.B_d, "B_d", f32, (n,)),
              (sys.labels, "labels", torch.int32, (n,)),
              (b_segm0, "b_segm0", f32, (k,)),
              (prior.b_prior, "b_prior", f32, (k,)),
              (prior.lambda_t_w, "lambda_t_w", f32, (k,)),
              (sys.cluster_counts, "cluster_counts", f32, (k,)),
              (sys.valid_count, "valid_count", f32, ()),
              (reg_ata, "reg_ata", f32, (k, k)))
    if isinstance(kb, torch.Tensor):
        inputs += ((kb, "kb", f32, ()),)
        kb_ptr, kb_val = kb.data_ptr(), 0.0
    else:
        kb_ptr, kb_val = None, float(s.kb if kb is None else kb)
    filter_on = accumulated_twist is not None
    if filter_on:
        inputs += ((twist_old, "twist_old", f32, (6,)),
                   (accumulated_twist, "accumulated_twist", f32, (6,)))
        cf, df = motion_filter_weights(level, config)
        old_ptr, acc_ptr = twist_old.data_ptr(), accumulated_twist.data_ptr()
    else:
        cf = df = 0.0
        old_ptr = acc_ptr = None
    for t, name, dtype, shape in inputs:
        _build.require(t, name, dtype, shape)
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
    lib = _build.load()
    tiles, grid, scratch_n = launch_plan(n, _coresident_blocks(lib, dev))
    scratch = torch.empty(scratch_n, dtype=f32, device=dev)
    out = torch.empty(OUT_SIZE, dtype=f32, device=dev)
    solve_irls_cuda.launches += 1
    _build.check(lib.sf_irls_solve(
        sys.A_cT.data_ptr(), sys.A_dT.data_ptr(), sys.B_c.data_ptr(),
        sys.B_d.data_ptr(), sys.labels.data_ptr(), n, TILE, grid,
        b_segm0.data_ptr(), prior.b_prior.data_ptr(),
        prior.lambda_t_w.data_ptr(), sys.cluster_counts.data_ptr(),
        sys.valid_count.data_ptr(), reg_ata.data_ptr(), kb_ptr, kb_val,
        old_ptr, acc_ptr, cf, df, int(filter_on),
        scratch.data_ptr(), out.data_ptr(), s.max_iter_irls, s.kc_cauchy,
        s.lambda_prior, s.irls_delta_threshold, _build.stream_ptr(out)),
        "sf_irls_solve")
    return out


def _result(out: torch.Tensor) -> IRLSResult:
    return IRLSResult(twist=out[OUT_TWIST:OUT_TWIST + 6],
                      est_cov=out[OUT_COV:OUT_COV + 36].view(6, 6),
                      b_segm=out[OUT_BSEGM:OUT_BSEGM + NUM_CLUSTERS],
                      aver_res=out[OUT_AVER])


def solve_irls_cuda(sys: JacobianSystem, b_segm0: torch.Tensor,
                    prior: SegPrior, reg_ata: torch.Tensor, config: SFConfig,
                    kb=None) -> IRLSResult:
    """The coupled IRLS loop on the card; same results as solve_irls_xla up
    to float summation order.  The fields are views of one flat output."""
    return _result(irls_solve_flat(sys, b_segm0, prior, reg_ata, config,
                                   kb=kb))


def solve_irls_filtered_cuda(sys: JacobianSystem, b_segm0: torch.Tensor,
                             prior: SegPrior, reg_ata: torch.Tensor,
                             config: SFConfig, twist_old: torch.Tensor,
                             accumulated_twist, level: int, kb=None):
    """(IRLSResult, twist) of one launch: the coupled IRLS loop, then the
    motion filter of `level` on its twist when `accumulated_twist` is given
    (else the twist unfiltered).  Same results as solve_irls_xla followed
    by motion_filter up to float summation order."""
    out = irls_solve_flat(sys, b_segm0, prior, reg_ata, config, kb=kb,
                          twist_old=twist_old,
                          accumulated_twist=accumulated_twist, level=level)
    return _result(out), out[OUT_FILT:OUT_FILT + 6]


solve_irls_cuda.launches = 0
