"""Association record types and helpers shared with the sparse fuse (the
parts of staticfusion_tpu/fusion/association.py that fusion/sparse.py
imports; the F=1 texel association is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from staticfusion_tpu_torch.config import SFConfig


class UpdateRecords(NamedTuple):
    """Per-surfel-slot update from the matched pixel (dense over capacity)."""
    has_update: torch.Tensor  # (N,) bool
    pos: torch.Tensor         # (N, 3) new world position
    conf: torch.Tensor        # (N,) measurement confidence `a`
    color: torch.Tensor       # (N, 3)
    normal: torch.Tensor      # (N, 3) world
    radius: torch.Tensor      # (N,)


class NewSurfels(NamedTuple):
    """Per-pixel new unstable surfel candidates, compacted to the
    checkerboard-active subgrid."""
    is_new: torch.Tensor  # (P,) bool
    pos: torch.Tensor     # (P, 3) world
    conf: torch.Tensor    # (P,)
    color: torch.Tensor   # (P, 3)
    normal: torch.Tensor  # (P, 3) world
    radius: torch.Tensor  # (P,)


def _neighbours_ok(depth: torch.Tensor) -> torch.Tensor:
    """4-neighbours nonzero (data.vert checkNeighbours), zero-padded."""
    p = torch.nn.functional.pad(depth, (1, 1, 1, 1))
    return ((p[1:-1, :-2] != 0) & (p[1:-1, 2:] != 0)
            & (p[:-2, 1:-1] != 0) & (p[2:, 1:-1] != 0))


def active_subgrid(img: torch.Tensor, t_par: torch.Tensor) -> torch.Tensor:
    """(H, W[, C]) -> (H//2, W//2[, C]): pixels with u%2 == v%2 == t_par
    (data.vert:124).  `t_par` stays on the device: the rows and columns
    are picked with index_select instead of a host-side slice start."""
    rows, cols = img.shape[:2]
    dev = img.device
    ri = t_par + 2 * torch.arange(rows // 2, device=dev)
    ci = t_par + 2 * torch.arange(cols // 2, device=dev)
    return img.index_select(0, ri).index_select(1, ci)


def _new_surfels(raw, filt, is_new: torch.Tensor, rgb: torch.Tensor,
                 static_prob: torch.Tensor, pose: torch.Tensor, t_par,
                 config: SFConfig) -> NewSurfels:
    """New-measurement attributes (data.vert:83-106): position from the raw
    cloud, normal/radius from the filtered one, conf 0.08 iff
    probStatic > 0.5 (data.vert:171-180)."""
    fus = config.fusion
    R, t = pose[:3, :3], pose[:3, 3]
    sub = lambda a: active_subgrid(a, t_par)
    sp = sub(static_prob).reshape(-1)
    return NewSurfels(
        is_new=sub(is_new).reshape(-1),
        pos=sub(raw.pos).reshape(-1, 3) @ R.T + t,
        conf=torch.where(sp > fus.new_static_prob_gate,
                         torch.full_like(sp, fus.new_unstable_conf),
                         torch.zeros_like(sp)),
        color=sub(rgb).reshape(-1, 3),
        normal=sub(filt.normal).reshape(-1, 3) @ R.T,
        radius=sub(filt.radius).reshape(-1))
