"""StaticFusion in PyTorch: the per-frame RGB-D SLAM step of
`staticfusion_tpu` ported to PyTorch, with its three TPU kernels rewritten
as CUDA kernels for Hopper (csrc/).

Layout mirrors the JAX package:
  geometry/  SE(3) exp/log
  ops/       bilateral, pyramid, warp, derivatives, small SPD solves
  solver/    clustering, segmentation, joint IRLS, coarse-to-fine driver
  fusion/    surfel map, packed-key z-buffer, sparse fuse, prediction
  pipeline/  state, per-frame step, host driver (SlamSystem)
  io/        synthetic sequences, trajectory/ATE
  kernels/   CUDA kernel wrappers (+ build); sources in csrc/

Every function takes tensors on one device.  CPU tensors run the plain
PyTorch versions of the kernels; CUDA tensors run the CUDA kernels.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM numerics are fp32-sensitive (6x6/24x24 normal equations, SE(3)
# chains); the JAX package forces "highest" matmul precision for the same
# reason.  TF32 would keep ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from staticfusion_tpu_torch.config import (SFConfig, solver_preset_ctor,  # noqa: E402
                                           solver_preset_datasets)

__all__ = ["SFConfig", "solver_preset_ctor", "solver_preset_datasets",
           "__version__"]
