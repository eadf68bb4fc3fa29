"""Frozen copy of staticfusion_tpu_torch/fusion/association.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Per-pixel data association against the texel images (port of
staticfusion_tpu/fusion/association.py without the slot-routed oracle
`associate`; reference data.vert).

For the checkerboard-active pixels, a window of index-map texels around
the pixel is searched for the best matching surfel: ray-depth gate
|lambda (z_model - z_meas)| < 0.05, least point-to-ray distance, normal
gate (|n_z| < 0.75 or angle < 0.5 rad).  `associate_texels` (the texel
fuse, odd index factors such as the F=1 preset) routes each matched
pixel's update record to the winner's texel; colliding records average.
Unmatched active pixels become new unstable surfels.  The record types
and `_new_surfels` are shared with the sparse fuse (fusion/sparse.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.fusion.surfels import (FrameCloud, frame_cloud,
                                                   radial_confidence)
from sfbench.reference.sf.fusion.texelmap import (INVALID, TexelImages,
                                                    phase_decompose,
                                                    phase_window,
                                                    window_offsets)


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


class TexelUpdates(NamedTuple):
    """Update records routed to the winning surfel's texel (all (Ht, Wt)
    images).  Positions and normals stay in the camera frame: the affine
    merge commutes with the rigid transform, so the write-back converts to
    world once.  Records of two active pixels matching surfels in one
    texel are averaged (the reference resolves them by GL raster order,
    which depends on submission)."""
    has: torch.Tensor     # bool: the texel received >= 1 record
    pos: torch.Tensor     # (Ht, Wt, 3) camera-frame measurement position
    conf: torch.Tensor    # measurement confidence `a`
    color: torch.Tensor   # (Ht, Wt, 3)
    normal: torch.Tensor  # (Ht, Wt, 3) camera frame
    radius: torch.Tensor


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


class _Search(NamedTuple):
    active: torch.Tensor     # (H, W) bool checkerboard-in-time active pixels
    best_id: torch.Tensor    # (H, W) int64 winning surfel id, INVALID if none
    best_dv: torch.Tensor    # (H, W) int64 winning window offset (texels)
    best_du: torch.Tensor
    raw: FrameCloud          # cloud of the raw depth
    filt: FrameCloud         # cloud of the filtered depth
    meas_conf: torch.Tensor  # (H, W) min(probStatic, weighting, radialConf)


def _window_search(tex: TexelImages, raw_depth_m: torch.Tensor,
                   filtered_depth_m: torch.Tensor, static_prob: torch.Tensor,
                   tick: torch.Tensor, weighting: torch.Tensor,
                   config: SFConfig) -> _Search:
    """The data.vert search: every window candidate of every pixel is
    gated at once (candidates stacked on a leading axis); the winner is
    the least distance, the first in the GLSL's x-major scan order on
    ties."""
    cam = config.camera
    fus = config.fusion
    F = fus.index_factor
    rows, cols = raw_depth_m.shape
    dev = raw_depth_m.device

    raw = frame_cloud(raw_depth_m, config)
    filt = frame_cloud(filtered_depth_m, config)

    uu = torch.arange(cols, device=dev)[None, :]
    vv = torch.arange(rows, device=dev)[:, None]
    t_par = torch.remainder(tick.to(torch.int64), 2)
    active = ((uu % 2 == t_par) & (vv % 2 == t_par)
              & _neighbours_ok(raw_depth_m)
              & (raw_depth_m > 0.0) & (raw_depth_m <= fus.depth_max))

    # Per-pixel ray and lambda (data.vert:133-139).
    xl = ((uu + 0.5 - cam.cx) / cam.fx).to(torch.float32).expand(rows, cols)
    yl = ((vv + 0.5 - cam.cy) / cam.fy).to(torch.float32).expand(rows, cols)
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)
    n_meas = filt.normal
    n_meas_norm = torch.linalg.vector_norm(n_meas, dim=-1)

    names = ("has", "x", "y", "z", "nx", "ny", "nz", "idx")
    offs = [(dv, du) for du in window_offsets(F)
            for dv in window_offsets(F)]  # the GLSL's x-major scan order
    C = {}
    for name in names:
        img = getattr(tex, name)
        ph = phase_decompose(img.to(torch.float32) if name == "has" else img,
                             F)
        C[name] = torch.stack([phase_window(ph, dv, du, F)
                               for dv, du in offs])

    has = C["has"] > 0
    cx_, cy_, cz = C["x"], C["y"], C["z"]
    cnx, cny, cnz = C["nx"], C["ny"], C["nz"]
    depth_ok = (torch.abs(cz - raw_depth_m[None]) * lam[None]
                < fus.assoc_depth_gate)
    # Point-to-ray distance |cross(ray, c)| / |ray|.
    cxp = yl[None] * cz - cy_
    cyp = cx_ - xl[None] * cz
    czp = xl[None] * cy_ - yl[None] * cx_
    dist = torch.sqrt(cxp ** 2 + cyp ** 2 + czp ** 2) / lam[None]
    cdot = (cnx * n_meas[None, ..., 0] + cny * n_meas[None, ..., 1]
            + cnz * n_meas[None, ..., 2])
    cnorm = torch.sqrt(cnx ** 2 + cny ** 2 + cnz ** 2)
    cos_angle = torch.clamp(
        cdot / torch.clamp(cnorm * n_meas_norm[None], min=1e-12), -1.0, 1.0)
    norm_ok = ((torch.abs(cnz) < fus.assoc_normal_z_gate)
               | (torch.abs(torch.arccos(cos_angle)) < fus.assoc_angle_gate))
    ok = has & depth_ok & norm_ok & (dist < 1000.0)
    dz = torch.where(ok, dist, torch.full_like(dist, float("inf")))
    best_d, bi = torch.min(dz, dim=0)  # the first index on ties
    found = torch.isfinite(best_d)

    def select(picked, empty):
        return torch.where(found, picked, torch.full_like(picked, empty))

    best_id = torch.gather(C["idx"].to(torch.int64), 0, bi[None])[0]
    dvs = torch.tensor([o[0] for o in offs], device=dev)
    dus = torch.tensor([o[1] for o in offs], device=dev)
    radial = radial_confidence(rows, cols, cam.cx, cam.cy, dev)
    meas_conf = torch.minimum(static_prob, torch.minimum(weighting, radial))
    return _Search(active=active, best_id=select(best_id, INVALID),
                   best_dv=select(dvs[bi], 0), best_du=select(dus[bi], 0),
                   raw=raw, filt=filt, meas_conf=meas_conf)


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


def associate_texels(tex: TexelImages, raw_depth_m: torch.Tensor,
                     filtered_depth_m: torch.Tensor, rgb: torch.Tensor,
                     static_prob: torch.Tensor, pose: torch.Tensor,
                     tick: torch.Tensor, weighting: torch.Tensor,
                     config: SFConfig):
    """Association with the update records routed to the winner's texel.
    Returns (TexelUpdates, NewSurfels).

    No scatter: a record of pixel (v, u) matched at window offset
    (dv, du) lands on texel (F v + dv, F u + du), so for each offset the
    contributing records form a masked image whose targets are a phase
    bucket (dv mod F, du mod F) shifted by a whole pixel block.  The
    buckets are summed in the offsets' order (dv outer), then composed
    into the texel grid and divided by their record counts."""
    fus = config.fusion
    F = fus.index_factor
    rows, cols = raw_depth_m.shape
    dev = raw_depth_m.device

    s = _window_search(tex, raw_depth_m, filtered_depth_m, static_prob,
                       tick, weighting, config)
    matched = s.active & (s.best_id != INVALID)
    is_new = s.active & (s.best_id == INVALID)
    t_par = torch.remainder(tick.to(torch.int64), 2)

    payload = torch.stack([
        s.raw.pos[..., 0], s.raw.pos[..., 1], s.raw.pos[..., 2],
        s.meas_conf, rgb[..., 0], rgb[..., 1], rgb[..., 2],
        s.filt.normal[..., 0], s.filt.normal[..., 1], s.filt.normal[..., 2],
        s.filt.radius, torch.ones((rows, cols), device=dev)])  # (12, H, W)
    zero = torch.zeros((), device=dev)
    acc = [[None] * F for _ in range(F)]
    for dv in window_offsets(F):
        for du in window_offsets(F):
            m = matched & (s.best_dv == dv) & (s.best_du == du)
            contrib = torch.where(m[None], payload, zero)
            sv, bv = dv % F, dv // F
            su, bu = du % F, du // F
            if bv or bu:
                a = max(abs(bv), abs(bu))
                p = torch.nn.functional.pad(contrib, (a, a, a, a))
                contrib = p[:, a - bv:a - bv + rows, a - bu:a - bu + cols]
            acc[sv][su] = (contrib if acc[sv][su] is None
                           else acc[sv][su] + contrib)
    ph = torch.stack([torch.stack(r) for r in acc])       # (F, F, 12, H, W)
    rec = ph.permute(2, 3, 0, 4, 1).reshape(12, rows * F, cols * F)

    cnt = rec[11]
    has = cnt > 0.0
    inv = torch.where(has, 1.0 / torch.where(has, cnt, torch.ones_like(cnt)),
                      zero)
    avg = rec[:11] * inv[None]
    img3 = lambda i: torch.stack([avg[i], avg[i + 1], avg[i + 2]], dim=-1)
    upd = TexelUpdates(has=has, pos=img3(0), conf=avg[3], color=img3(4),
                       normal=img3(7), radius=avg[10])
    new = _new_surfels(s.raw, s.filt, is_new, rgb, static_prob, pose, t_par,
                       config)
    return upd, new
