"""Synthetic RGB-D sequence generator for tests and benchmarks (numpy copy
of staticfusion_tpu/io/synthetic.py; the per-frame twist goes through the
port's se3_exp instead of the JAX one).

The reference has no test data at all (SURVEY.md section 4); this module renders an
analytic textured world (axis-aligned planes + an optionally moving sphere)
by exact ray casting, so ground-truth poses and static/dynamic masks are
known exactly.  NumPy on host — test infrastructure, not part of the
compute path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Plane:
    point: np.ndarray    # (3,)
    normal: np.ndarray   # (3,) unit, pointing toward open space


@dataclasses.dataclass
class Sphere:
    center: np.ndarray   # (3,)
    radius: float
    velocity: np.ndarray  # (3,) per-frame motion


def default_world() -> Tuple[List[Plane], Optional[Sphere]]:
    planes = [
        Plane(np.array([0.0, 0.0, 3.0]), np.array([0.0, 0.0, -1.0])),   # back wall
        Plane(np.array([0.0, 1.1, 0.0]), np.array([0.0, -1.0, 0.0])),   # floor
        Plane(np.array([-1.6, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),   # left wall
        Plane(np.array([1.6, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])),   # right wall
    ]
    return planes, None


def _texture(p: np.ndarray) -> np.ndarray:
    """Procedural rgb texture of world points (..., 3) -> (..., 3) in [0,1]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * np.sin(7.0 * x) + 0.15 * np.sin(13.0 * y + 1.0)
    g = 0.5 + 0.25 * np.sin(5.0 * y + 2.0) + 0.15 * np.sin(11.0 * z)
    b = 0.5 + 0.25 * np.sin(6.0 * z + 1.5) + 0.15 * np.sin(9.0 * x + 0.7)
    return np.clip(np.stack([r, g, b], axis=-1), 0.05, 0.95)


def render_frame(pose: np.ndarray, config, planes: List[Plane] = None,
                 sphere: Optional[Sphere] = None, depth_noise: float = 0.0,
                 rng: Optional[np.random.Generator] = None):
    """Render (rgb[H,W,3] float, depth_mm[H,W] float, dynamic_mask[H,W]) seen
    from camera-to-world `pose` with the config's fusion intrinsics."""
    if planes is None:
        planes, _ = default_world()
    cam = config.camera
    rows, cols = cam.height, cam.width
    u = np.arange(cols) + 0.5
    v = np.arange(rows) + 0.5
    uu, vv = np.meshgrid(u, v)
    dirs_cam = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                         np.ones_like(uu)], axis=-1)
    R, t = pose[:3, :3], pose[:3, 3]
    dirs = dirs_cam @ R.T
    origin = t

    best_t = np.full((rows, cols), np.inf)
    hit_dyn = np.zeros((rows, cols), bool)

    for pl in planes:
        denom = dirs @ pl.normal
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        ti = ((pl.point - origin) @ pl.normal) / denom
        ok = (ti > 0.05) & (ti < best_t)
        best_t = np.where(ok, ti, best_t)

    if sphere is not None:
        oc = origin - sphere.center
        b = np.sum(dirs * oc, axis=-1)
        c = oc @ oc - sphere.radius ** 2
        a = np.sum(dirs * dirs, axis=-1)
        disc = b * b - a * c
        with np.errstate(invalid="ignore"):
            ti = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        ok = (disc > 0) & (ti > 0.05) & (ti < best_t)
        best_t = np.where(ok, ti, best_t)
        hit_dyn = ok

    pts = origin + dirs * best_t[..., None]
    depth = best_t * dirs_cam[..., 2]  # camera z, = best_t since dir z == 1
    depth = np.where(np.isfinite(depth), depth, 0.0)
    rgb = _texture(pts)
    rgb = np.where(np.isfinite(best_t)[..., None], rgb, 0.0)

    if depth_noise > 0 and rng is not None:
        depth = depth + rng.normal(0.0, depth_noise, depth.shape) * (depth > 0)

    depth_mm = np.round(np.clip(depth, 0.0, 60.0) * 1000.0)
    return rgb.astype(np.float32), depth_mm.astype(np.float32), hit_dyn


def make_sequence(config, n_frames: int, twist_per_frame: np.ndarray,
                  sphere: Optional[Sphere] = None, depth_noise: float = 0.0,
                  seed: int = 0):
    """Moving-camera sequence; returns (frames, gt_poses).

    frames: list of (rgb, depth_mm, dyn_mask); gt_poses: (n, 4, 4)
    camera-to-world."""
    import torch

    from staticfusion_tpu_torch.geometry.se3 import se3_exp

    rng = np.random.default_rng(seed)
    planes, _ = default_world()
    dT = se3_exp(torch.as_tensor(np.asarray(twist_per_frame, np.float32))
                 ).numpy()
    pose = np.eye(4, dtype=np.float32)
    frames, poses = [], []
    sp = dataclasses.replace(sphere) if sphere is not None else None
    for i in range(n_frames):
        frames.append(render_frame(pose, config, planes, sp,
                                   depth_noise=depth_noise, rng=rng))
        poses.append(pose.copy())
        pose = (pose @ dT).astype(np.float32)
        if sp is not None:
            sp.center = sp.center + sp.velocity
    return frames, np.stack(poses)
