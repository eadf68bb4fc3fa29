"""K3 wrapper: the IRLS kernel chain (csrc/irls.cu).

Plain version: `solve_irls_xla` (solver/irls.py, re-exported here).
`solve_irls_cuda.launches` counts solves (one chain of up to
4 * max_iter_irls kernel launches each).
"""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.config import NUM_CLUSTERS, SFConfig
from staticfusion_tpu_torch.kernels import _build
from staticfusion_tpu_torch.kernels.smallsolve import spd_inverse_cuda
from staticfusion_tpu_torch.solver.irls import (IRLSResult,  # noqa: F401
                                                JacobianSystem,
                                                initial_aver_res,
                                                solve_irls_xla)
from staticfusion_tpu_torch.solver.segmentation import SegPrior

TILE = 2048  # pixels per pass block (256 threads x 8 pixels)


def solve_irls_cuda(sys: JacobianSystem, b_segm0: torch.Tensor,
                    prior: SegPrior, reg_ata: torch.Tensor, config: SFConfig,
                    kb=None) -> IRLSResult:
    """The coupled IRLS loop on the card; same results as solve_irls_xla up
    to float summation order.  `kb` may be a float or a device scalar."""
    s = config.solver
    k = NUM_CLUSTERS
    dev = sys.B_c.device
    n = sys.B_c.shape[0]
    if n == 0:
        raise ValueError("empty Jacobian system")
    at = torch.cat([sys.A_cT, sys.A_dT]).to(torch.float32).contiguous()
    b2 = torch.stack([sys.B_c, sys.B_d]).to(torch.float32).contiguous()
    lbl = sys.labels.to(torch.int32).contiguous()
    prior2 = torch.stack([prior.b_prior, prior.lambda_t_w]).to(
        torch.float32).contiguous()
    counts = sys.cluster_counts.to(torch.float32).contiguous()
    reg = reg_ata.to(torch.float32).contiguous()
    for t, name, shape in ((at, "A", (12, n)), (b2, "B", (2, n)),
                           (lbl, "labels", (n,)), (prior2, "prior", (2, k)),
                           (counts, "cluster_counts", (k,)),
                           (reg, "reg_ata", (k, k))):
        _build.require(t, name, torch.int32 if name == "labels"
                       else torch.float32, shape)

    n2, aver0 = initial_aver_res(sys)
    kb_t = torch.as_tensor(s.kb if kb is None else kb, dtype=torch.float32,
                           device=dev).reshape(1)
    one = torch.ones(1, device=dev)
    # State layout: ST_* in csrc/irls.cu (twist, b_ext, aver_res, pending,
    # done, kb, n2).
    st = torch.cat([torch.zeros(6, device=dev),
                    b_segm0.to(torch.float32).reshape(k), one,
                    aver0.reshape(1), torch.zeros(2, device=dev), kb_t,
                    n2.reshape(1)]).contiguous()
    tiles = -(-n // TILE)
    part0 = torch.empty(tiles * 27, device=dev)
    part1 = torch.empty(tiles * (k + 1), device=dev)
    out = torch.empty(32, device=dev)
    out_ata = torch.empty(36, device=dev)
    lib = _build.load()
    solve_irls_cuda.launches += 1
    _build.check(lib.sf_irls_solve(
        at.data_ptr(), b2.data_ptr(), lbl.data_ptr(), n, TILE, st.data_ptr(),
        prior2.data_ptr(), counts.data_ptr(), reg.data_ptr(),
        part0.data_ptr(), part1.data_ptr(), out.data_ptr(),
        out_ata.data_ptr(), s.max_iter_irls, s.kc_cauchy, s.lambda_prior,
        s.irls_delta_threshold, _build.stream_ptr(at)), "sf_irls_solve")
    est_cov = spd_inverse_cuda(out_ata.reshape(6, 6), ridge=1e-12) * out[31]
    return IRLSResult(twist=out[0:6], est_cov=est_cov, b_segm=out[6:30],
                      aver_res=out[30])


solve_irls_cuda.launches = 0
