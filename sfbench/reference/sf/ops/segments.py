"""Frozen copy of staticfusion_tpu_torch/ops/segments.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Per-bin sums as a one-hot product (port of
staticfusion_tpu/ops/segments.py::bincount_matmul — the only part of that
module the per-frame path uses).  A float scatter-add would be
nondeterministic on CUDA; the one-hot contraction is not."""

from __future__ import annotations

import torch


def bincount_matmul(labels: torch.Tensor, values: torch.Tensor,
                    valid: torch.Tensor, n_bins: int):
    """(sums, counts) per bin; labels (N,) in [0, n_bins], invalid entries
    and label n_bins drop out."""
    lbl = torch.where(valid, labels, torch.full_like(labels, n_bins))
    one_hot = (lbl[:, None] == torch.arange(
        n_bins, device=labels.device)[None, :]).to(values.dtype)
    return one_hot.T @ values, torch.sum(one_hot, dim=0)
