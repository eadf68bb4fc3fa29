"""Closed-form SE(3)/SO(3) exponential and logarithm maps (port of
staticfusion_tpu/geometry/se3.py): Rodrigues forms with Taylor guards
around theta = 0.  Twist layout xi = (vx, vy, vz, wx, wy, wz)."""

from __future__ import annotations

import torch


def hat3(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee3(K: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.stack([K[..., 2, 1] - K[..., 1, 2],
                              K[..., 0, 2] - K[..., 2, 0],
                              K[..., 1, 0] - K[..., 0, 1]], dim=-1)


def _guarded(theta, small_val, big_fn):
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, small_val, big_fn(safe))


def _sinc(theta):
    return _guarded(theta, 1.0 - theta * theta / 6.0,
                    lambda s: torch.sin(s) / s)


def _cosc(theta):
    return _guarded(theta, 0.5 - theta * theta / 24.0,
                    lambda s: (1.0 - torch.cos(s)) / (s * s))


def _vterm(theta):
    return _guarded(theta, 1.0 / 6.0 - theta * theta / 120.0,
                    lambda s: (s - torch.sin(s)) / (s ** 3))


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(
        ref.shape[:-2] + (3, 3))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle.  Valid for theta < pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0))
    small = theta < 1e-4
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(small, torch.ones_like(theta),
                                            torch.sin(theta)))
    return scale[..., None] * vee3(R)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(...,6) twist -> (...,4,4) rigid transform."""
    v, w = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.vector_norm(w, dim=-1)
    K = hat3(w)
    K2 = K @ K
    eye = _eye3(K)
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    c = _vterm(theta)[..., None, None]
    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    t = torch.einsum("...ij,...j->...i", V, v)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype,
                         device=xi.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) rigid transform -> (...,6) twist (v, w)."""
    w = so3_log(T[..., :3, :3])
    t = T[..., :3, 3]
    theta = torch.linalg.vector_norm(w, dim=-1)
    K = hat3(w)
    K2 = K @ K
    # V^-1 = I - K/2 + coef K^2, coef -> 1/12 as theta -> 0.
    coef = _guarded(theta, 1.0 / 12.0 + theta * theta / 720.0,
                    lambda s: (1.0 / (s * s))
                    - (1.0 + torch.cos(s)) / (2.0 * s * torch.sin(s)))
    Vinv = _eye3(K) - 0.5 * K + coef[..., None, None] * K2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([v, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    return torch.cat([top, T[..., 3:4, :]], dim=-2)


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,3)."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]
