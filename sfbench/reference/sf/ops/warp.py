"""Frozen copy of staticfusion_tpu_torch/ops/warp.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Inverse warp of the prediction onto the current grid (port of the
gather formulation in staticfusion_tpu/ops/warp.py; the forward splat
`warp_images_inverse` is not on the per-frame path and is not ported)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sfbench.reference.sf.geometry.se3 import se3_inverse
from sfbench.reference.sf.ops.pyramid import PyramidLevel


class WarpedImages(NamedTuple):
    depth: torch.Tensor
    intensity: torch.Tensor
    xx: torch.Tensor
    yy: torch.Tensor


def solver_camera_params(rows_i: int, cols_i: int, fovh: float):
    f = float(cols_i) / (2.0 * math.tan(0.5 * fovh))
    return f, 0.5 * (cols_i - 1), 0.5 * (rows_i - 1)


def _bilinear_sample(fields: torch.Tensor, valid: torch.Tensor,
                     u: torch.Tensor, v: torch.Tensor, rows_i: int,
                     cols_i: int):
    """Validity-weighted bilinear sampling of (C, rows*cols) fields at
    continuous (u, v) (N,).  Returns ((C, N) samples, (N,) weight)."""
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    fu = u - u0f
    fv = v - v0f
    u0 = torch.clamp(u0f.to(torch.int64), 0, cols_i - 1)
    v0 = torch.clamp(v0f.to(torch.int64), 0, rows_i - 1)

    c = fields.shape[0]
    imgs = torch.cat([fields, valid.reshape(1, -1).to(fields.dtype)],
                     dim=0).reshape(c + 1, rows_i, cols_i)
    padded = torch.nn.functional.pad(imgs, (0, 1, 0, 1))
    flat = v0 * cols_i + u0
    acc = torch.zeros((c, u.shape[0]), dtype=fields.dtype,
                      device=fields.device)
    wacc = torch.zeros_like(u)
    corners = (((0, 0), (1 - fu) * (1 - fv)), ((0, 1), fu * (1 - fv)),
               ((1, 0), (1 - fu) * fv), ((1, 1), fu * fv))
    for (dv, du), w in corners:
        shifted = padded[:, dv:dv + rows_i, du:du + cols_i].reshape(c + 1, -1)
        blk = shifted[:, flat]
        wgt = w * blk[c]
        acc = acc + blk[:c] * wgt[None, :]
        wacc = wacc + wgt
    safe = torch.where(wacc > 0.0, wacc, torch.ones_like(wacc))
    return acc / safe[None, :], wacc


def warp_images_gather(pred: PyramidLevel, cur_depth: torch.Tensor,
                       T_odometry: torch.Tensor, fovh: float) -> WarpedImages:
    """Resample the prediction onto the current grid: each current pixel's
    back-projected point goes through T_odometry into the predicted view,
    where depth/intensity are sampled bilinearly (validity-weighted); the
    sampled point is re-expressed in the current frame."""
    rows_i, cols_i = pred.depth.shape
    f, disp_u, disp_v = solver_camera_params(rows_i, cols_i, fovh)
    dtype, dev = pred.depth.dtype, pred.depth.device

    uu = torch.arange(cols_i, dtype=dtype, device=dev)[None, :] - disp_u
    vv = torch.arange(rows_i, dtype=dtype, device=dev)[:, None] - disp_v
    inv_f = 1.0 / f
    z_c = cur_depth
    x_c = uu * z_c * inv_f
    y_c = vv * z_c * inv_f

    T = T_odometry
    x_p = T[0, 0] * x_c + T[0, 1] * y_c + T[0, 2] * z_c + T[0, 3]
    y_p = T[1, 0] * x_c + T[1, 1] * y_c + T[1, 2] * z_c + T[1, 3]
    z_p = T[2, 0] * x_c + T[2, 1] * y_c + T[2, 2] * z_c + T[2, 3]

    ok = (z_c != 0.0) & (z_p > 0.0)
    safe_z = torch.where(ok, z_p, torch.ones_like(z_p))
    u_s = f * x_p / safe_z + disp_u
    v_s = f * y_p / safe_z + disp_v
    ok = ok & ((u_s >= 0.0) & (u_s <= cols_i - 1) & (v_s >= 0.0)
               & (v_s <= rows_i - 1))
    u_s = torch.clamp(u_s, 0.0, cols_i - 1).reshape(-1)
    v_s = torch.clamp(v_s, 0.0, rows_i - 1).reshape(-1)

    fields = torch.stack([pred.depth.reshape(-1), pred.intensity.reshape(-1)])
    samples, w = _bilinear_sample(fields, pred.depth != 0.0, u_s, v_s,
                                  rows_i, cols_i)
    hit = ok.reshape(-1) & (w > 0.0)

    d_s, i_s = samples[0], samples[1]
    xx_s = (u_s - disp_u) * d_s * (1.0 / f)
    yy_s = (v_s - disp_v) * d_s * (1.0 / f)
    Ti = se3_inverse(T_odometry)
    z_w = Ti[2, 0] * xx_s + Ti[2, 1] * yy_s + Ti[2, 2] * d_s + Ti[2, 3]
    hit = hit & (z_w > 0.0)

    zero = torch.zeros_like(z_w)
    depth_w = torch.where(hit, z_w, zero).reshape(rows_i, cols_i)
    intensity_w = torch.where(hit, i_s, zero).reshape(rows_i, cols_i)
    nonzero = depth_w != 0.0
    z2 = torch.zeros_like(depth_w)
    xx_w = torch.where(nonzero, uu * depth_w * inv_f, z2)
    yy_w = torch.where(nonzero, vv * depth_w * inv_f, z2)
    return WarpedImages(depth=depth_w, intensity=intensity_w, xx=xx_w,
                        yy=yy_w)
