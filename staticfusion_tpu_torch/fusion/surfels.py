"""Surfel map storage and per-frame oriented clouds (port of
staticfusion_tpu/fusion/surfels.py).

The map is a fixed-capacity structure of arrays (the reference's packed
vec4 VBO, Vertex.cpp:21-40); a validity mask replaces the transform-feedback
`count`, and `used` is the append high-water mark.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from staticfusion_tpu_torch.config import SFConfig


class SurfelMap(NamedTuple):
    pos: torch.Tensor        # (N, 3) world
    conf: torch.Tensor       # (N,)
    color: torch.Tensor      # (N, 3) rgb in [0,1]
    hist: torch.Tensor       # (N,) times-seen weight
    init_time: torch.Tensor  # (N,) first-seen tick
    last_time: torch.Tensor  # (N,) last-update tick
    normal: torch.Tensor     # (N, 3) world
    radius: torch.Tensor     # (N,)
    valid: torch.Tensor      # (N,) bool
    used: torch.Tensor       # () int32: slots [0, used) have held a surfel

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def pack_rows(smap: SurfelMap) -> torch.Tensor:
    """(N, 14) float rows: pos, conf, color, hist, init/last time, normal,
    radius (the layout of compaction and the lifecycle/insert pass)."""
    col = lambda a: a[:, None]
    return torch.cat([smap.pos, col(smap.conf), smap.color, col(smap.hist),
                      col(smap.init_time), col(smap.last_time), smap.normal,
                      col(smap.radius)], dim=1)


def unpack_rows(out: torch.Tensor, valid: torch.Tensor,
                used: torch.Tensor) -> SurfelMap:
    return SurfelMap(pos=out[:, 0:3], conf=out[:, 3], color=out[:, 4:7],
                     hist=out[:, 7], init_time=out[:, 8],
                     last_time=out[:, 9], normal=out[:, 10:13],
                     radius=out[:, 13], valid=valid, used=used)


def empty_map(capacity: int, device=None) -> SurfelMap:
    z3 = torch.zeros((capacity, 3), device=device)
    z1 = torch.zeros((capacity,), device=device)
    return SurfelMap(pos=z3, conf=z1, color=z3.clone(), hist=z1.clone(),
                     init_time=z1.clone(), last_time=z1.clone(),
                     normal=z3.clone(), radius=z1.clone(),
                     valid=torch.zeros((capacity,), dtype=torch.bool,
                                       device=device),
                     used=torch.zeros((), dtype=torch.int32, device=device))


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def next_tier(n: int) -> int:
    """Smallest map tier >= n from the {2^k, 1.5*2^k} ladder."""
    p = next_pow2(n)
    if n <= (p >> 2) * 3:
        return (p >> 2) * 3
    return p


def concat_maps(a: SurfelMap, b: SurfelMap) -> SurfelMap:
    """Stack two maps slot-wise (capacity a+b)."""
    cat = SurfelMap(*[torch.cat([x, y]) for x, y in zip(a[:-1], b[:-1])],
                    used=a.used)
    return cat._replace(used=(a.capacity + b.used).to(torch.int32))


def compact_map(smap: SurfelMap, new_capacity: int,
                keep_mask=None) -> SurfelMap:
    """Pack the kept surfels (default: valid) into the prefix of a
    `new_capacity` map, in ascending slot order.  Kept surfels beyond the
    new capacity drop."""
    cap = smap.capacity
    dev = smap.pos.device
    keep = smap.valid if keep_mask is None else (smap.valid & keep_mask)
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    if new_capacity <= cap:
        order = order[:new_capacity]
    else:
        order = torch.cat([order, torch.zeros(new_capacity - cap,
                                              dtype=order.dtype, device=dev)])
    n_valid = torch.sum(keep.to(torch.int32))
    has = torch.arange(new_capacity, device=dev) < n_valid
    safe = torch.where(has, order, torch.zeros_like(order))
    out = torch.where(has[:, None], pack_rows(smap)[safe],
                      torch.zeros((), device=dev))
    used = torch.clamp(n_valid, max=new_capacity).to(torch.int32)
    return unpack_rows(out, keep[safe] & has, used)


class FrameCloud(NamedTuple):
    pos: torch.Tensor     # (H, W, 3) camera frame
    normal: torch.Tensor  # (H, W, 3)
    radius: torch.Tensor  # (H, W)
    conf: torch.Tensor    # (H, W) radial confidence
    valid: torch.Tensor   # (H, W) 0 < z <= maxDepth


def _pixel_centres(rows: int, cols: int, device):
    x = torch.arange(cols, dtype=torch.float32, device=device)[None, :] + 0.5
    y = torch.arange(rows, dtype=torch.float32, device=device)[:, None] + 0.5
    return x, y


def radial_confidence(rows: int, cols: int, cx: float, cy: float,
                      device=None) -> torch.Tensor:
    """Radial Gaussian confidence (surfels.glsl; maxRadDist = 200)."""
    x, y = _pixel_centres(rows, cols, device)
    rd2 = ((x - cx) ** 2 + (y - cy) ** 2) / (200.0 ** 2)
    return torch.exp(-rd2 / (2.0 * 0.72))


def backproject_fusion(depth_m: torch.Tensor,
                       config: SFConfig) -> torch.Tensor:
    """(H, W, 3) camera-frame positions, fusion intrinsics at pixel
    centres."""
    cam = config.camera
    x, y = _pixel_centres(depth_m.shape[0], depth_m.shape[1], depth_m.device)
    px = (x - cam.cx) * depth_m / cam.fx
    py = (y - cam.cy) * depth_m / cam.fy
    return torch.stack([px.expand(depth_m.shape), py.expand(depth_m.shape),
                        depth_m], dim=-1)


def compute_normals(pos: torch.Tensor) -> torch.Tensor:
    """Central-difference normals, edge-clamped (geometry.glsl getNormal);
    they point away from the camera."""
    rows, cols = pos.shape[:2]
    dev = pos.device
    ri = torch.clamp(torch.arange(-1, rows + 1, device=dev), 0, rows - 1)
    ci = torch.clamp(torch.arange(-1, cols + 1, device=dev), 0, cols - 1)
    p = pos[ri][:, ci]
    del_x = 0.5 * (p[1:-1, :-2] - p[1:-1, 2:])
    del_y = 0.5 * (p[:-2, 1:-1] - p[2:, 1:-1])
    n = torch.linalg.cross(del_x, del_y, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-12)


def compute_radius(depth_m: torch.Tensor, normal_z: torch.Tensor,
                   config: SFConfig) -> torch.Tensor:
    """surfels.glsl getRadius: (z/meanFocal)*sqrt2 / |n_z|, capped at 2r."""
    cam = config.camera
    r = depth_m / (0.5 * (cam.fx + cam.fy)) * math.sqrt(2.0)
    return torch.minimum(2.0 * r,
                         r / torch.clamp(torch.abs(normal_z), min=1e-6))


def frame_cloud(depth_m: torch.Tensor, config: SFConfig) -> FrameCloud:
    """vertex_feedback.vert for one metric depth image."""
    pos = backproject_fusion(depth_m, config)
    normal = compute_normals(pos)
    cam = config.camera
    return FrameCloud(
        pos=pos, normal=normal,
        radius=compute_radius(depth_m, normal[..., 2], config),
        conf=radial_confidence(depth_m.shape[0], depth_m.shape[1], cam.cx,
                               cam.cy, depth_m.device),
        valid=(depth_m > 0.0) & (depth_m <= config.fusion.depth_max))


def quantize8(x: torch.Tensor) -> torch.Tensor:
    """Round-trip through the 8-bit colour codec (color.glsl)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0


def initialise_map(capacity: int, raw_depth_m: torch.Tensor,
                   filtered_depth_m: torch.Tensor, rgb: torch.Tensor,
                   static_prob: torch.Tensor, pose: torch.Tensor,
                   config: SFConfig) -> SurfelMap:
    """First-frame map (GlobalModel::initialise + init_unstable.vert):
    positions/colours from the raw cloud, normals/radii from the filtered
    one, confidence = 8-bit-quantised static probability, times 1."""
    dev = raw_depth_m.device
    raw = frame_cloud(raw_depth_m, config)
    filt = frame_cloud(filtered_depth_m, config)
    n = min(raw_depth_m.numel(), capacity)
    R, t = pose[:3, :3], pose[:3, 3]
    valid = raw.valid.reshape(-1)[:n]
    v3 = valid[:, None]
    zero = torch.zeros((), device=dev)
    validf = valid.to(torch.float32)
    cols = [torch.where(v3, (raw.pos.reshape(-1, 3) @ R.T + t)[:n], zero),
            torch.where(valid, quantize8(static_prob.reshape(-1))[:n],
                        zero)[:, None],
            torch.where(v3, rgb.reshape(-1, 3)[:n], zero),
            validf[:, None], validf[:, None], validf[:, None],
            torch.where(v3, (filt.normal.reshape(-1, 3) @ R.T)[:n], zero),
            torch.where(valid, filt.radius.reshape(-1)[:n], zero)[:, None]]
    out = torch.zeros((capacity, 14), device=dev)
    out[:n] = torch.cat(cols, dim=1)
    valid_all = torch.zeros(capacity, dtype=torch.bool, device=dev)
    valid_all[:n] = valid
    return unpack_rows(out, valid_all,
                   torch.tensor(n, dtype=torch.int32, device=dev))
