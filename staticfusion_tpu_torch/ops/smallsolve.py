"""Small SPD solves (port of staticfusion_tpu/ops/smallsolve.py).

`spd_solve` / `spd_inverse` are the plain versions: unrolled Cholesky-Crout
plus substitutions, the same arithmetic as the JAX package's CPU path.
`spd_solve_fast` / `spd_inverse_fast` dispatch on the device: the CUDA
kernel (kernels/smallsolve.py, csrc/smallsolve.cu) for CUDA tensors, the
plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.kernels._build import on_cuda

_RIDGE_FLOOR = 1e-30


def spd_solve_fast(M: torch.Tensor, b: torch.Tensor,
                   ridge: float = 0.0) -> torch.Tensor:
    if on_cuda(M):
        from staticfusion_tpu_torch.kernels.smallsolve import spd_solve_cuda
        return spd_solve_cuda(M, b, ridge=ridge)
    return spd_solve(M, b, ridge=ridge)


def spd_inverse_fast(M: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    if on_cuda(M):
        from staticfusion_tpu_torch.kernels.smallsolve import \
            spd_inverse_cuda
        return spd_inverse_cuda(M, ridge=ridge)
    return spd_inverse(M, ridge=ridge)


def cholesky_factor(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with M = L L^T (unrolled Cholesky-Crout)."""
    n = M.shape[0]
    row_idx = torch.arange(n, device=M.device)
    L = torch.zeros_like(M)
    for j in range(n):
        s = M[:, j] if j == 0 else M[:, j] - L[:, :j] @ L[j, :j]
        djj = torch.sqrt(torch.clamp(s[j], min=_RIDGE_FLOOR))
        L[:, j] = torch.where(row_idx >= j, s / djj, torch.zeros_like(s))
    return L


def _forward_sub(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = torch.zeros_like(b)
    for i in range(L.shape[0]):
        acc = b[i] if i == 0 else b[i] - L[i, :i] @ y[:i]
        y[i] = acc / L[i, i]
    return y


def _backward_sub(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    n = L.shape[0]
    x = torch.zeros_like(y)
    for i in reversed(range(n)):
        acc = y[i] if i == n - 1 else y[i] - L[i + 1:, i] @ x[i + 1:]
        x[i] = acc / L[i, i]
    return x


def _ridged(M: torch.Tensor, ridge: float) -> torch.Tensor:
    if ridge:
        return M + ridge * torch.eye(M.shape[0], dtype=M.dtype,
                                     device=M.device)
    return M


def spd_solve(M: torch.Tensor, b: torch.Tensor,
              ridge: float = 0.0) -> torch.Tensor:
    """x = (M + ridge I)^-1 b; b is (n,) or (n, m)."""
    L = cholesky_factor(_ridged(M, ridge))
    return _backward_sub(L, _forward_sub(L, b))


def spd_inverse(M: torch.Tensor, ridge: float = 0.0) -> torch.Tensor:
    """(M + ridge I)^-1."""
    L = cholesky_factor(_ridged(M, ridge))
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    return _backward_sub(L, _forward_sub(L, eye))
