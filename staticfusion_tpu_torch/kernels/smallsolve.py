"""K2 wrappers: the warp Cholesky solve and inverse (csrc/smallsolve.cu).

Plain versions: `spd_solve` / `spd_inverse` (ops/smallsolve.py,
re-exported here).  `.launches` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.kernels import _build
from staticfusion_tpu_torch.ops.smallsolve import (spd_inverse,  # noqa: F401
                                                   spd_solve)


def _check_system(M: torch.Tensor) -> int:
    _build.require(M, "M", torch.float32)
    n = M.shape[0]
    if M.dim() != 2 or M.shape[1] != n or not 1 <= n <= 32:
        raise ValueError(f"M: expected (n, n) with n <= 32, got "
                         f"{tuple(M.shape)}")
    return n


def spd_solve_cuda(M: torch.Tensor, b: torch.Tensor,
                   ridge: float = 0.0) -> torch.Tensor:
    """x = (M + ridge I)^-1 b; b is (n,) or (n, m) with m <= 32."""
    n = _check_system(M)
    b2 = b.reshape(n, 1) if b.dim() == 1 else b
    _build.require(b2, "b", torch.float32)
    if b2.dim() != 2 or b2.shape[0] != n or not 1 <= b2.shape[1] <= 32:
        raise ValueError(f"b: expected (n,) or (n, m<=32), got "
                         f"{tuple(b.shape)}")
    if b2.device != M.device:
        raise ValueError("M and b must be on one device")
    m = b2.shape[1]
    x = torch.empty((n, m), dtype=torch.float32, device=M.device)
    lib = _build.load()
    spd_solve_cuda.launches += 1
    _build.check(lib.sf_spd_solve(M.data_ptr(), b2.data_ptr(), x.data_ptr(),
                                  n, m, float(ridge), 0,
                                  _build.stream_ptr(M)), "sf_spd_solve")
    return x.reshape(b.shape)


def spd_inverse_cuda(M: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    """(M + ridge I)^-1."""
    n = _check_system(M)
    x = torch.empty((n, n), dtype=torch.float32, device=M.device)
    lib = _build.load()
    spd_inverse_cuda.launches += 1
    _build.check(lib.sf_spd_solve(M.data_ptr(), M.data_ptr(), x.data_ptr(),
                                  n, n, float(ridge), 1,
                                  _build.stream_ptr(M)), "sf_spd_solve")
    return x


spd_solve_cuda.launches = 0
spd_inverse_cuda.launches = 0
