"""Intermediate coordinates, depth-adaptive derivatives and solver
pre-weights (port of staticfusion_tpu/ops/derivatives.py; reference
FrontEnd.cpp:393-510)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from staticfusion_tpu_torch.ops.pyramid import PyramidLevel
from staticfusion_tpu_torch.ops.warp import WarpedImages

EPS_INTENSITY = 1e-6
EPS_DEPTH = 0.005


class InterCoords(NamedTuple):
    depth: torch.Tensor
    intensity: torch.Tensor
    xx: torch.Tensor
    yy: torch.Tensor
    null: torch.Tensor    # bool: either depth is missing
    valid: torch.Tensor   # bool: non-null AND strictly inside the border


class Derivatives(NamedTuple):
    dcu: torch.Tensor
    dcv: torch.Tensor
    dct: torch.Tensor
    ddu: torch.Tensor
    ddv: torch.Tensor
    ddt: torch.Tensor


class PreWeights(NamedTuple):
    weights_c: torch.Tensor
    weights_d: torch.Tensor


def _grid(img: torch.Tensor):
    rows_i, cols_i = img.shape
    vv = torch.arange(rows_i, device=img.device)[:, None]
    uu = torch.arange(cols_i, device=img.device)[None, :]
    return vv, uu, rows_i, cols_i


def calculate_coords(cur: PyramidLevel, warped: WarpedImages) -> InterCoords:
    """Midpoint of current and warped images (FrontEnd.cpp:393-430)."""
    both = (cur.depth != 0.0) & (warped.depth != 0.0)
    zero = torch.zeros_like(cur.depth)
    vv, uu, rows_i, cols_i = _grid(cur.depth)
    inner = (vv > 0) & (vv < rows_i - 1) & (uu > 0) & (uu < cols_i - 1)
    return InterCoords(
        depth=torch.where(both, 0.5 * (cur.depth + warped.depth), zero),
        intensity=0.5 * (cur.intensity + warped.intensity),
        xx=torch.where(both, 0.5 * (cur.xx + warped.xx), zero),
        yy=torch.where(both, 0.5 * (cur.yy + warped.yy), zero),
        null=~both, valid=both & inner)


def _shift(img, dv, du):
    """img[v+dv, u+du], wrapping (jnp.roll semantics of the original)."""
    return torch.roll(torch.roll(img, -dv, dims=0), -du, dims=1)


def calculate_derivatives(inter: InterCoords, cur: PyramidLevel,
                          warped: WarpedImages) -> Derivatives:
    """Depth-adaptive weighted central differences (FrontEnd.cpp:432-479)."""
    d, c = inter.depth, inter.intensity
    vv, uu, rows_i, cols_i = _grid(d)
    not_null = ~inter.null
    right = not_null & (uu < cols_i - 1)
    down = not_null & (vv < rows_i - 1)
    one = torch.ones_like(d)

    rx = torch.where(right, torch.abs(_shift(d, 0, 1) - d) + EPS_DEPTH, one)
    rx_c = torch.where(right, torch.abs(_shift(c, 0, 1) - c) + EPS_INTENSITY,
                       one)
    ry = torch.where(down, torch.abs(_shift(d, 1, 0) - d) + EPS_DEPTH, one)
    ry_c = torch.where(down, torch.abs(_shift(c, 1, 0) - c) + EPS_INTENSITY,
                       one)

    inner = (vv > 0) & (vv < rows_i - 1) & (uu > 0) & (uu < cols_i - 1)
    write = inner & not_null

    def weighted_central(img, r_pos, axis):
        if axis == 0:
            r_neg = _shift(r_pos, -1, 0)
            fwd = _shift(img, 1, 0) - img
            bwd = img - _shift(img, -1, 0)
        else:
            r_neg = _shift(r_pos, 0, -1)
            fwd = _shift(img, 0, 1) - img
            bwd = img - _shift(img, 0, -1)
        return (r_neg * fwd + r_pos * bwd) / (r_pos + r_neg)

    zero = torch.zeros_like(d)
    return Derivatives(
        dcu=torch.where(write, weighted_central(c, rx_c, 1), zero),
        dcv=torch.where(write, weighted_central(c, ry_c, 0), zero),
        dct=cur.intensity - warped.intensity,
        ddu=torch.where(write, weighted_central(d, rx, 1), zero),
        ddv=torch.where(write, weighted_central(d, ry, 0), zero),
        ddt=cur.depth - warped.depth)


def compute_weights(deriv: Derivatives, valid: torch.Tensor) -> PreWeights:
    """Pre-weights from the linearisation-error estimate
    (FrontEnd.cpp:481-510), max-normalised over the valid set."""
    k_c, k_d = 10.0, 200.0
    err_m_c, err_m_d = 1.0, 0.01
    err_l_c = k_c * (torch.abs(deriv.dct) + torch.abs(deriv.dcu)
                     + torch.abs(deriv.dcv))
    err_l_d = k_d * (torch.abs(deriv.ddt) + torch.abs(deriv.ddu)
                     + torch.abs(deriv.ddv))
    zero = torch.zeros_like(err_l_c)
    w_c = torch.where(valid, torch.sqrt(1.0 / (err_m_c + err_l_c)), zero)
    w_d = torch.where(valid, torch.sqrt(1.0 / (err_m_d + err_l_d)), zero)
    max_c = torch.clamp(torch.max(w_c), min=1e-20)
    max_d = torch.clamp(torch.max(w_d), min=1e-20)
    return PreWeights(weights_c=w_c / max_c, weights_d=w_d / max_d)
