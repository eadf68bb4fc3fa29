"""The walk_xyz and corridor_loop profiles of the port's adversarial
generator (staticfusion_tpu_torch/io/adversarial.py), rendered in PyTorch
so that a run's frames are made on the card in a few batched calls.

The scene (room or corridor planes, static clutter spheres, the
articulated walker), the camera trajectories, the textures and the
Kinect-v1 sensor model are copies of that module's; only the random
numbers differ: the sensor noise is drawn from a `torch.Generator` seeded
with the run's seed, on the device that renders.  The ray casting runs in
float64, as the numpy original does, and the outputs are the float32
arrays that `SlamSystem.process` takes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from sfbench.reference.sf.geometry.se3 import se3_exp


class Plane(NamedTuple):
    point: tuple
    normal: tuple


@dataclasses.dataclass
class SphereT:
    center_fn: Callable[[float], np.ndarray]
    radius: float
    dynamic: bool = False
    albedo: Optional[tuple] = None  # flat colour; None -> world texture


@dataclasses.dataclass(frozen=True)
class SensorModel:
    """Kinect-v1-style degradations (the original's defaults)."""
    axial_noise: float = 1.425e-3     # sigma_z = axial_noise * z^2  [m]
    speckle_dropout: float = 0.015    # random invalid-depth fraction
    shadow_grad: float = 0.08         # depth-discontinuity threshold [m]
    shadow_width: int = 3             # dropout band width at discontinuities
    grazing_cos: float = 0.12         # |n . view| below this -> no return
    exposure_amp: float = 0.10        # rolling intensity amplitude
    exposure_rate: float = 0.23       # rad/frame
    rgb_noise: float = 0.012          # per-pixel intensity noise sigma
    depth_max_mm: float = 60000.0


class Camera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class Sequence(NamedTuple):
    rgb: np.ndarray       # (n, H, W, 3) float32 in [0, 1]
    depth_mm: np.ndarray  # (n, H, W) float32 carrying u16 millimetres
    dynamic: np.ndarray   # (n, H, W) bool: the walker, where depth is valid
    gt_poses: np.ndarray  # (n, 4, 4) float32 camera-to-world


# -- worlds ------------------------------------------------------------------

def _static(center) -> Callable[[float], np.ndarray]:
    c = np.asarray(center, np.float64)
    return lambda t: c


def room_planes() -> List[Plane]:
    return [Plane((0.0, 0.0, 3.2), (0.0, 0.0, -1.0)),
            Plane((0.0, 1.2, 0.0), (0.0, -1.0, 0.0)),
            Plane((0.0, -1.2, 0.0), (0.0, 1.0, 0.0)),
            Plane((-2.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
            Plane((2.0, 0.0, 0.0), (-1.0, 0.0, 0.0))]


def static_clutter() -> List[SphereT]:
    return [SphereT(_static([-1.2, 0.75, 2.4]), 0.42),
            SphereT(_static([1.25, 0.8, 2.1]), 0.38),
            SphereT(_static([-0.7, -0.6, 2.8]), 0.30),
            SphereT(_static([0.9, -0.55, 2.9]), 0.26),
            SphereT(_static([0.1, 1.0, 2.55]), 0.22),
            SphereT(_static([-1.55, -0.1, 2.7]), 0.33)]


_SKIN = (0.75, 0.58, 0.48)
_SHIRT = (0.25, 0.35, 0.65)
_PANTS = (0.30, 0.28, 0.26)


def make_walker(x0: float = 0.0, z: float = 1.35, speed: float = 0.045,
                span: float = 0.65, scale: float = 1.0,
                limb_rate: float = 0.9) -> List[SphereT]:
    """The articulated walker of walk_xyz: head, torso, arms and legs as
    spheres on one back-and-forth base motion with phase-offset limbs."""
    def base(t):
        return x0 + span * math.sin(speed * t)

    def part(dy, r, swing=0.0, phase=0.0, dz=0.0):
        def fn(t):
            limb = scale * swing * math.sin(limb_rate * t + phase)
            return np.array([base(t) + limb, scale * dy, z + scale * dz
                             + 0.12 * math.sin(0.31 * t)])
        return fn

    s = scale
    return [
        SphereT(part(-0.70, 0.18), s * 0.18, True, _SKIN),
        SphereT(part(-0.28, 0.34), s * 0.34, True, _SHIRT),
        SphereT(part(0.14, 0.32), s * 0.32, True, _SHIRT),
        SphereT(part(-0.28, 0.15, 0.24, 0.0, -0.06), s * 0.15, True, _SKIN),
        SphereT(part(-0.28, 0.15, 0.24, math.pi, -0.06), s * 0.15, True,
                _SKIN),
        SphereT(part(0.62, 0.17, 0.20, math.pi / 2), s * 0.17, True, _PANTS),
        SphereT(part(0.62, 0.17, 0.20, -math.pi / 2), s * 0.17, True,
                _PANTS),
    ]


def trajectory_walk_xyz(n: int) -> np.ndarray:
    """(n, 6) per-frame twists: handheld translation and moderate rotation."""
    t = np.arange(n)
    vx = 0.010 * np.cos(0.17 * t)
    vy = 0.006 * np.sin(0.23 * t + 0.4)
    vz = 0.008 * np.sin(0.11 * t)
    wx = 0.004 * np.sin(0.19 * t + 1.0)
    wy = 0.006 * np.cos(0.13 * t)
    wz = 0.003 * np.sin(0.29 * t)
    return np.stack([vx, vy, vz, wx, wy, wz], axis=1).astype(np.float32)


def corridor_planes(length: float = 12.0) -> List[Plane]:
    return [Plane((0.0, 0.0, length), (0.0, 0.0, -1.0)),
            Plane((0.0, 0.0, -2.0), (0.0, 0.0, 1.0)),
            Plane((0.0, 1.2, 0.0), (0.0, -1.0, 0.0)),
            Plane((0.0, -1.2, 0.0), (0.0, 1.0, 0.0)),
            Plane((-1.2, 0.0, 0.0), (1.0, 0.0, 0.0)),
            Plane((1.2, 0.0, 0.0), (-1.0, 0.0, 0.0))]


def trajectory_corridor_loop(n: int, depth: float = 8.0) -> np.ndarray:
    """Dolly `depth` metres down the corridor over n/2 frames, then back,
    facing forward, with handheld wobble on all axes."""
    m = n // 2
    t = np.arange(m)
    vz = np.full(m, depth / m)
    vx = 0.004 * np.sin(0.23 * t)
    vy = 0.003 * np.sin(0.31 * t + 0.5)
    wx = 0.0015 * np.sin(0.19 * t)
    wy = 0.002 * np.sin(0.13 * t + 1.0)
    wz = 0.001 * np.sin(0.29 * t)
    out = np.stack([vx, vy, vz, wx, wy, wz], axis=1)
    tw = np.concatenate([out, -out[::-1]], axis=0)
    if tw.shape[0] < n:
        tw = np.concatenate([tw, np.zeros((n - tw.shape[0], 6))], axis=0)
    return tw.astype(np.float32)


def make_corridor_walker(n_frames: int, depth: float = 8.0,
                         enter: float = 0.12,
                         leave: float = 0.48) -> List[SphereT]:
    """A walker pacing ~2 m ahead of the outbound camera during
    [enter*n, leave*n], parked behind the back wall otherwise."""
    m = n_frames // 2
    t_in, t_out = enter * n_frames, leave * n_frames

    def cam_z(t):
        return depth * min(t, m) / m if t <= m else depth * (2.0 - t / m)

    def part(dy, r, swing=0.0, phase=0.0, dz=0.0):
        def fn(t):
            if t < t_in or t > t_out:
                return np.array([0.0, dy, -9.0])
            x = 0.55 * math.sin(0.17 * (t - t_in))
            limb = swing * math.sin(0.9 * t + phase)
            return np.array([x + limb, dy,
                             cam_z(t) + 2.0 + dz
                             + 0.10 * math.sin(0.27 * t)])
        return fn

    return [
        SphereT(part(-0.62, 0.16), 0.16, True, _SKIN),
        SphereT(part(-0.26, 0.30), 0.30, True, _SHIRT),
        SphereT(part(0.12, 0.28), 0.28, True, _SHIRT),
        SphereT(part(-0.26, 0.13, 0.22, 0.0, -0.05), 0.13, True, _SKIN),
        SphereT(part(-0.26, 0.13, 0.22, math.pi, -0.05), 0.13, True, _SKIN),
        SphereT(part(0.55, 0.15, 0.18, math.pi / 2), 0.15, True, _PANTS),
        SphereT(part(0.55, 0.15, 0.18, -math.pi / 2), 0.15, True, _PANTS),
    ]


def corridor_clutter(length: float = 12.0) -> List[SphereT]:
    rng = np.random.default_rng(7)
    out = []
    for i in range(10):
        z = 0.8 + i * (length - 1.6) / 9.0
        side = 1 if i % 2 == 0 else -1
        out.append(SphereT(
            _static([side * (0.85 + 0.2 * rng.random()),
                     0.7 + 0.3 * rng.random(), z]),
            0.18 + 0.12 * rng.random()))
    return out


class Scene(NamedTuple):
    twists: np.ndarray
    planes: List[Plane]
    spheres: List[SphereT]
    corridor_texture: bool


def scene(profile: str, n_frames: int) -> Scene:
    if profile == "walk_xyz":
        return Scene(trajectory_walk_xyz(n_frames), room_planes(),
                     static_clutter() + make_walker(), False)
    if profile == "corridor_loop":
        return Scene(trajectory_corridor_loop(n_frames), corridor_planes(),
                     corridor_clutter() + make_corridor_walker(n_frames),
                     True)
    raise ValueError(f"unknown profile {profile!r}")


def gt_poses(twists: np.ndarray) -> np.ndarray:
    """(n, 4, 4) float32 camera-to-world poses: the identity, then each
    frame's twist applied in turn, in float32 as the original chains
    them."""
    pose = np.eye(4, dtype=np.float32)
    out = []
    for tw in twists:
        out.append(pose.copy())
        dT = se3_exp(torch.as_tensor(tw)).numpy()
        pose = (pose @ dT).astype(np.float32)
    return np.stack(out)


# -- textures ----------------------------------------------------------------

def _texture(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * torch.sin(7.0 * x) + 0.15 * torch.sin(13.0 * y + 1.0)
    g = 0.5 + 0.25 * torch.sin(5.0 * y + 2.0) + 0.15 * torch.sin(11.0 * z)
    b = 0.5 + 0.25 * torch.sin(6.0 * z + 1.5) + 0.15 * torch.sin(9.0 * x + 0.7)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.05, 0.95)


def _texture_adv(p: torch.Tensor) -> torch.Tensor:
    """World texture with a high-frequency component and a texture-poor
    patch on the back wall."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    hf = 0.08 * torch.sin(41.0 * x) * torch.sin(37.0 * y + 0.5)
    tex = torch.clamp(_texture(p) + hf[..., None], 0.03, 0.97)
    flat = (z > 3.1) & (x > -0.3) & (x < 1.1) & (y > -0.9) & (y < 0.1)
    return torch.where(flat[..., None], torch.full_like(tex, 0.62), tex)


def _texture_corridor(p: torch.Tensor) -> torch.Tensor:
    """_texture_adv plus a chirped (non-repeating) component along z."""
    z = p[..., 2]
    chirp = (0.12 * torch.sin(0.9 * z + 0.25 * z * z)
             * torch.sin(3.1 * p[..., 1] + 1.7 * p[..., 0]))
    return torch.clamp(_texture_adv(p) + chirp[..., None], 0.03, 0.97)


# -- renderer ----------------------------------------------------------------

def _sensor(depth, rgb, cos_inc, frame_idx, sm: SensorModel,
            gen: torch.Generator):
    """The sensor model on a batch: grazing and shadow dropouts, speckle,
    axial noise and u16 quantisation, rolling exposure and rgb noise."""
    valid = (depth > 0) & (torch.abs(cos_inc) > sm.grazing_cos)
    dz_u = torch.abs(torch.diff(depth, dim=2, prepend=depth[:, :, :1]))
    dz_v = torch.abs(torch.diff(depth, dim=1, prepend=depth[:, :1, :]))
    edge = (dz_u > sm.shadow_grad) | (dz_v > sm.shadow_grad)
    shadow = edge.clone()
    for _ in range(sm.shadow_width - 1):
        shadow[:, :, 1:] |= edge[:, :, :-1]
        edge = shadow.clone()
    valid &= ~shadow
    dev, f64 = depth.device, torch.float64
    speckle = torch.rand(depth.shape, generator=gen, device=dev, dtype=f64)
    valid &= speckle > sm.speckle_dropout
    noise = torch.randn(depth.shape, generator=gen, device=dev, dtype=f64)
    noisy = depth + noise * (sm.axial_noise * depth * depth)
    depth_mm = torch.round(torch.clamp(noisy * 1000.0, 0.0, sm.depth_max_mm))
    depth_mm = torch.where(valid, depth_mm, torch.zeros_like(depth_mm))
    gain = 1.0 + sm.exposure_amp * torch.sin(sm.exposure_rate * frame_idx)
    rgb_noise = torch.randn(rgb.shape, generator=gen, device=dev, dtype=f64)
    rgb = torch.clamp(rgb * gain[:, None, None, None]
                      + sm.rgb_noise * rgb_noise, 0.0, 1.0)
    return rgb.to(torch.float32), depth_mm.to(torch.float32)


def render_batch(poses: np.ndarray, frame_idx: np.ndarray, cam: Camera,
                 sc: Scene, sm: SensorModel, gen: torch.Generator,
                 device) -> tuple:
    """(rgb, depth_mm, dynamic) of the frames seen from the camera-to-world
    `poses` (B, 4, 4) at frame numbers `frame_idx` (B,), on `device`."""
    f64 = torch.float64
    dev = torch.device(device)
    B = poses.shape[0]
    u = torch.arange(cam.width, dtype=f64, device=dev) + 0.5
    v = torch.arange(cam.height, dtype=f64, device=dev) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs_cam = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                            torch.ones_like(uu)], dim=-1)
    P = torch.as_tensor(np.asarray(poses, np.float64), device=dev)
    R, origin = P[:, :3, :3], P[:, :3, 3]
    dirs = torch.einsum("hwj,bij->bhwi", dirs_cam, R)
    o = origin[:, None, None, :]
    shape = (B, cam.height, cam.width)
    best_t = torch.full(shape, math.inf, dtype=f64, device=dev)
    normal = torch.zeros(shape + (3,), dtype=f64, device=dev)
    albedo = torch.full(shape + (3,), math.nan, dtype=f64, device=dev)
    hit_dyn = torch.zeros(shape, dtype=torch.bool, device=dev)

    for pl in sc.planes:
        n = torch.tensor(pl.normal, dtype=f64, device=dev)
        p0 = torch.tensor(pl.point, dtype=f64, device=dev)
        denom = dirs @ n
        denom = torch.where(torch.abs(denom) < 1e-9,
                            torch.full_like(denom, 1e-9), denom)
        ti = ((p0 - origin) @ n)[:, None, None] / denom
        ok = (ti > 0.05) & (ti < best_t)
        best_t = torch.where(ok, ti, best_t)
        normal = torch.where(ok[..., None], n, normal)
        hit_dyn &= ~ok

    centres = torch.as_tensor(np.array(
        [[sp.center_fn(float(t)) for sp in sc.spheres] for t in frame_idx],
        np.float64), device=dev)  # (B, S, 3)
    for s, sp in enumerate(sc.spheres):
        c = centres[:, s][:, None, None, :]
        oc = o - c
        b = torch.sum(dirs * oc, dim=-1)
        cq = torch.sum(oc * oc, dim=-1) - sp.radius ** 2
        a = torch.sum(dirs * dirs, dim=-1)
        disc = b * b - a * cq
        ti = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
        ok = (disc > 0) & (ti > 0.05) & (ti < best_t)
        best_t = torch.where(ok, ti, best_t)
        n_s = (o + dirs * ti[..., None] - c) / sp.radius
        normal = torch.where(ok[..., None], n_s, normal)
        hit_dyn = torch.where(ok, torch.full_like(hit_dyn, sp.dynamic),
                              hit_dyn)
        alb = (torch.tensor(sp.albedo, dtype=f64, device=dev)
               if sp.albedo is not None
               else torch.full((3,), math.nan, dtype=f64, device=dev))
        albedo = torch.where(ok[..., None], alb, albedo)

    pts = o + dirs * best_t[..., None]
    finite = torch.isfinite(best_t)
    depth = torch.where(finite, best_t, torch.zeros_like(best_t))
    tex = (_texture_corridor if sc.corridor_texture else _texture_adv)(pts)
    dnorm = torch.clamp(torch.linalg.vector_norm(dirs, dim=-1), min=1e-9)
    lam = 0.55 + 0.45 * torch.clamp(-torch.sum(normal * dirs, dim=-1)
                                    / dnorm, 0.0, 1.0)
    rgb = torch.where(torch.isnan(albedo), tex, albedo * lam[..., None])
    rgb = torch.where((depth > 0)[..., None], rgb, torch.zeros_like(rgb))
    cos_inc = torch.sum(normal * (dirs / dnorm[..., None]), dim=-1)
    fidx = torch.as_tensor(np.asarray(frame_idx, np.float64), device=dev)
    rgb, depth_mm = _sensor(depth, rgb, cos_inc, fidx, sm, gen)
    return rgb, depth_mm, hit_dyn & (depth_mm > 0)


def render_sequence(profile: str, n_frames: int, cam: Camera, seed: int,
                    device, sensor: Optional[SensorModel] = None,
                    batch: int = 16) -> Sequence:
    """The profile's first `n_frames` frames, rendered on `device` in
    batches of `batch` frames and copied to host memory.  The seed sets the
    sensor noise alone: the scene and the trajectory are the profile's."""
    sc = scene(profile, n_frames)
    sm = SensorModel() if sensor is None else sensor
    poses = gt_poses(sc.twists)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    rgb = np.empty((n_frames, cam.height, cam.width, 3), np.float32)
    depth = np.empty((n_frames, cam.height, cam.width), np.float32)
    dyn = np.empty((n_frames, cam.height, cam.width), bool)
    for i in range(0, n_frames, batch):
        j = min(n_frames, i + batch)
        r, d, m = render_batch(poses[i:j], np.arange(i, j), cam, sc, sm,
                               gen, device)
        rgb[i:j], depth[i:j], dyn[i:j] = (r.cpu().numpy(), d.cpu().numpy(),
                                          m.cpu().numpy())
    return Sequence(rgb, depth, dyn, poses)
