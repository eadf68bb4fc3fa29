"""Depth-aware image pyramid (port of staticfusion_tpu/ops/pyramid.py;
reference `createImagePyramid`, FrontEnd.cpp:256-391).

Per 2x level: inner pixels blend a 4x4 neighbourhood with the separable
(1,2,2,1)^2/36 mask, gated by similarity to the second-largest depth of the
central 2x2 block; border pixels take a plain 2x2 mean (non-zero mean for
depth).  Zero depth is the invalid sentinel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from staticfusion_tpu_torch.config import SFConfig

MAX_DEPTH_DIF = 0.1


class PyramidLevel(NamedTuple):
    depth: torch.Tensor      # (rows_i, cols_i) metres, 0 = invalid
    intensity: torch.Tensor  # (rows_i, cols_i) grayscale
    xx: torch.Tensor         # lateral x coordinate image (solver camera)
    yy: torch.Tensor


Pyramid = Tuple[PyramidLevel, ...]


def _conv_mask(ref: torch.Tensor) -> torch.Tensor:
    v = torch.tensor([1.0, 2.0, 2.0, 1.0], dtype=ref.dtype, device=ref.device)
    return v[:, None] * v[None, :] / 36.0


def _blocks_4x4(img: torch.Tensor, rows_o: int, cols_o: int) -> torch.Tensor:
    """(..., rows_o, cols_o, 4, 4) neighbourhoods img[2v-1+a, 2u-1+b],
    zero-padded."""
    p = torch.nn.functional.pad(img, (1, 1, 1, 1))
    rows = []
    for a in range(4):
        cols = [p[..., a:a + 2 * rows_o:2, b:b + 2 * cols_o:2]
                for b in range(4)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def downsample_level(depth_prev: torch.Tensor, intensity_prev: torch.Tensor):
    """One 2x depth-aware downsample (inputs may carry leading batch dims)."""
    rows_o, cols_o = depth_prev.shape[-2] // 2, depth_prev.shape[-1] // 2
    d_blk = _blocks_4x4(depth_prev, rows_o, cols_o)
    i_blk = _blocks_4x4(intensity_prev, rows_o, cols_o)

    central = torch.stack([d_blk[..., 1, 1], d_blk[..., 2, 1],
                           d_blk[..., 1, 2], d_blk[..., 2, 2]], dim=-1)
    dcenter = torch.sort(central, dim=-1).values[..., 2]

    mask = _conv_mask(depth_prev)
    abs_dif = torch.abs(d_blk - dcenter[..., None, None])
    w = torch.where(abs_dif < MAX_DEPTH_DIF, mask * (MAX_DEPTH_DIF - abs_dif),
                    torch.zeros_like(abs_dif))
    w_sum = torch.sum(w, dim=(-1, -2))
    safe_w = torch.where(w_sum > 0, w_sum, torch.ones_like(w_sum))
    zero = torch.zeros_like(dcenter)
    d_inner = torch.where(dcenter != 0.0,
                          torch.sum(w * d_blk, dim=(-1, -2)) / safe_w, zero)
    i_gated = torch.sum(w * i_blk, dim=(-1, -2)) / safe_w
    i_plain = torch.sum(mask * i_blk, dim=(-1, -2))
    i_inner = torch.where(dcenter != 0.0, i_gated, i_plain)

    c_i = torch.stack([i_blk[..., 1, 1], i_blk[..., 2, 1],
                       i_blk[..., 1, 2], i_blk[..., 2, 2]], dim=-1)
    i_border = 0.25 * torch.sum(c_i, dim=-1)
    cnt = torch.sum((central != 0.0).to(central.dtype), dim=-1)
    d_border = torch.where(
        cnt > 0, torch.sum(central, dim=-1)
        / torch.where(cnt > 0, cnt, torch.ones_like(cnt)), zero)

    dev = depth_prev.device
    vv = torch.arange(rows_o, device=dev)[:, None]
    uu = torch.arange(cols_o, device=dev)[None, :]
    border = (vv == 0) | (vv == rows_o - 1) | (uu == 0) | (uu == cols_o - 1)
    return (torch.where(border, d_border, d_inner),
            torch.where(border, i_border, i_inner))


def coords_for_level(depth: torch.Tensor, fovh: float):
    """Back-projected lateral coordinates with the solver camera (single
    focal from fovh, principal point (n-1)/2; FrontEnd.cpp:377-388)."""
    rows_i, cols_i = depth.shape[-2:]
    inv_f = 2.0 * math.tan(0.5 * fovh) / float(cols_i)
    uu = (torch.arange(cols_i, dtype=depth.dtype, device=depth.device)[None, :]
          - 0.5 * (cols_i - 1))
    vv = (torch.arange(rows_i, dtype=depth.dtype, device=depth.device)[:, None]
          - 0.5 * (rows_i - 1))
    return inv_f * uu * depth, inv_f * vv * depth


def build_pyramid_pair(depth_a: torch.Tensor, intensity_a: torch.Tensor,
                       depth_b: torch.Tensor, intensity_b: torch.Tensor,
                       config: SFConfig) -> Tuple[Pyramid, Pyramid]:
    """Two pyramids (`config.ctf_levels` levels each) in one batched pass."""
    d = torch.stack([depth_a, depth_b])
    i = torch.stack([intensity_a, intensity_b])
    fovh = config.camera.fovh
    la, lb = [], []
    for lvl in range(config.ctf_levels):
        if lvl > 0:
            d, i = downsample_level(d, i)
        xx, yy = coords_for_level(d, fovh)
        la.append(PyramidLevel(d[0], i[0], xx[0], yy[0]))
        lb.append(PyramidLevel(d[1], i[1], xx[1], yy[1]))
    return tuple(la), tuple(lb)
