"""Surfel-major ("sparse") fuse for even super-resolution index factors
(port of staticfusion_tpu/fusion/sparse.py; reference data.vert /
update.vert / copy_unstable.vert at FACTOR=4).

Every texel-winning surfel has a unique checkerboard-active candidate pixel
(even F), so association runs per surfel: it gathers that pixel's
measurement, applies the data.vert gates and competes for the pixel with a
packed (quantised distance << id_bits | id) scatter-min.  Each pixel keeps
at most one surfel, so the update records route pixel -> slot without
collisions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion.association import (NewSurfels,
                                                       UpdateRecords,
                                                       _neighbours_ok,
                                                       _new_surfels,
                                                       active_subgrid)
from staticfusion_tpu_torch.fusion.surfels import (SurfelMap, frame_cloud,
                                                   pack_rows,
                                                   radial_confidence,
                                                   unpack_rows)
from staticfusion_tpu_torch.fusion.texelmap import (INT_MAX, INVALID,
                                                    SurfelsLocal, id_bits_for,
                                                    packed_keys, render_cull,
                                                    scatter_min)

# Point-to-ray distances of window candidates are bounded by the window
# reach (~1.5 px at F=4/QVGA, <= 0.026 m); 0.1 m of range leaves 4x margin.
DIST_CAP = 0.1


def post_factor_config(config: SFConfig) -> SFConfig:
    """Config of the post-merge render: `post_factor` texels per pixel
    (0 = index_factor)."""
    P = config.fusion.post_factor or config.fusion.index_factor
    if P == config.fusion.index_factor:
        return config
    return config.replace(
        fusion=dataclasses.replace(config.fusion, index_factor=P))


def supports_sparse(config: SFConfig) -> bool:
    """Even F > 1 has the unique-active-candidate-pixel property."""
    F = config.fusion.index_factor
    return F > 1 and F % 2 == 0


def zbuffer_winners(smap: SurfelMap, local: SurfelsLocal, tick: torch.Tensor,
                    config: SFConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ok, is_winner): render-cull mask and per-surfel z-buffer verdict on
    the F-resolution texel grid (packed depth keys, smaller id on ties)."""
    cam = config.camera
    fus = config.fusion
    F = fus.index_factor
    cols4 = cam.width * F
    S = cam.height * F * cols4
    ib = id_bits_for(smap.capacity)
    ok = render_cull(smap, local, tick, config)
    flat = torch.where(ok, local.v4 * cols4 + local.u4,
                       torch.full_like(local.u4, S))
    key = packed_keys(local.pos[:, 2], fus.depth_max, ib)
    fb = scatter_min(flat, key, S)
    return ok, ok & (fb[flat] == key)


def candidate_pixel(t: torch.Tensor, t_par: torch.Tensor, F: int,
                    limit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coord, valid): the unique checkerboard-active pixel per axis whose
    association window holds texel `t` (floor division throughout)."""
    w = F // 2
    lo = torch.div(t - w, F, rounding_mode="floor")
    hi = torch.div(t + w, F, rounding_mode="floor")
    act = lo + (torch.remainder(lo, 2) != t_par).to(lo.dtype)
    return act, (act <= hi) & (act >= 0) & (act < limit)


class SparseAssoc(NamedTuple):
    updates: UpdateRecords
    new: NewSurfels
    best_id: torch.Tensor    # (H, W) int64 winner per pixel, INVALID if none
    matched: torch.Tensor    # (H, W) bool
    active: torch.Tensor     # (H, W) bool
    is_winner: torch.Tensor  # (capacity,) pre-merge z-buffer winners
    flat: torch.Tensor       # (capacity,) flat texel index (S = culled)


def associate_sparse(smap: SurfelMap, local: SurfelsLocal,
                     raw_depth_m: torch.Tensor,
                     filtered_depth_m: torch.Tensor, rgb: torch.Tensor,
                     static_prob: torch.Tensor, pose: torch.Tensor,
                     tick: torch.Tensor, weighting: torch.Tensor,
                     config: SFConfig) -> SparseAssoc:
    """The data.vert association, surfel-major."""
    cam = config.camera
    fus = config.fusion
    F = fus.index_factor
    rows, cols = raw_depth_m.shape
    n_pix = rows * cols
    dev = raw_depth_m.device
    ib = id_bits_for(smap.capacity)
    t_par = torch.remainder(tick.to(torch.int64), 2)

    raw = frame_cloud(raw_depth_m, config)
    filt = frame_cloud(filtered_depth_m, config)

    uu = torch.arange(cols, device=dev)[None, :]
    vv = torch.arange(rows, device=dev)[:, None]
    active = ((uu % 2 == t_par) & (vv % 2 == t_par)
              & _neighbours_ok(raw_depth_m)
              & (raw_depth_m > 0.0) & (raw_depth_m <= fus.depth_max))

    ok, is_win = zbuffer_winners(smap, local, tick, config)
    u_act, u_ok = candidate_pixel(local.u4, t_par, F, cols)
    v_act, v_ok = candidate_pixel(local.v4, t_par, F, rows)
    pix_ok = is_win & u_ok & v_ok
    pflat = torch.clamp(v_act * cols + u_act, 0, n_pix - 1)

    meas = torch.stack([raw_depth_m, active.to(torch.float32),
                        filt.normal[..., 0], filt.normal[..., 1],
                        filt.normal[..., 2]]).reshape(5, n_pix)
    g = meas[:, pflat]
    z_meas, act_g = g[0], g[1] > 0.0
    nmx, nmy, nmz = g[2], g[3], g[4]

    # data.vert:133-160 gates, per surfel against its candidate pixel.
    xl = (u_act.to(torch.float32) + 0.5 - cam.cx) / cam.fx
    yl = (v_act.to(torch.float32) + 0.5 - cam.cy) / cam.fy
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)
    cx_, cy_, cz = local.pos[:, 0], local.pos[:, 1], local.pos[:, 2]
    cnx, cny, cnz = local.normal[:, 0], local.normal[:, 1], local.normal[:, 2]
    depth_ok = torch.abs(cz - z_meas) * lam < fus.assoc_depth_gate
    cxp = yl * cz - cy_
    cyp = cx_ - xl * cz
    czp = xl * cy_ - yl * cx_
    dist = torch.sqrt(cxp ** 2 + cyp ** 2 + czp ** 2) / lam
    n_meas_norm = torch.sqrt(nmx * nmx + nmy * nmy + nmz * nmz)
    cdot = cnx * nmx + cny * nmy + cnz * nmz
    cnorm = torch.sqrt(cnx ** 2 + cny ** 2 + cnz ** 2)
    cos_angle = torch.clamp(
        cdot / torch.clamp(cnorm * n_meas_norm, min=1e-12), -1.0, 1.0)
    norm_ok = ((torch.abs(cnz) < fus.assoc_normal_z_gate)
               | (torch.abs(torch.arccos(cos_angle)) < fus.assoc_angle_gate))
    cand = pix_ok & act_g & depth_ok & norm_ok

    # Best candidate per pixel: packed (quantised distance, id) scatter-min.
    tgt = torch.where(cand, pflat, torch.full_like(pflat, n_pix))
    pbuf = scatter_min(tgt, packed_keys(dist, DIST_CAP, ib), n_pix)[:n_pix]
    best_flat = torch.where(pbuf != INT_MAX, pbuf & ((1 << ib) - 1),
                            torch.full_like(pbuf, INVALID))
    best_id = best_flat.reshape(rows, cols)
    matched = active & (best_id != INVALID)
    is_new = active & (best_id == INVALID)

    # Update records, pixel -> slot: unique slots by construction; the
    # unmatched rows go to the sentinel row `capacity`.
    radial = radial_confidence(rows, cols, cam.cx, cam.cy, dev)
    meas_conf = torch.minimum(static_prob, torch.minimum(weighting, radial))
    R, t = pose[:3, :3], pose[:3, 3]
    sub = lambda a: active_subgrid(a, t_par)
    matched_sub = sub(matched).reshape(-1)
    slot = torch.where(matched_sub, sub(best_id).reshape(-1),
                       torch.full_like(matched_sub, smap.capacity,
                                       dtype=torch.int64))
    n_sub = matched_sub.shape[0]
    payload = torch.cat([
        sub(raw.pos).reshape(-1, 3) @ R.T + t,
        sub(meas_conf).reshape(-1, 1), sub(rgb).reshape(-1, 3),
        sub(filt.normal).reshape(-1, 3) @ R.T,
        sub(filt.radius).reshape(-1, 1),
        torch.ones((n_sub, 1), device=dev)], dim=1)
    rec = torch.zeros((smap.capacity + 1, payload.shape[1]), device=dev)
    rec.index_copy_(0, slot, payload)
    rec = rec[:smap.capacity]
    updates = UpdateRecords(has_update=rec[:, 11] > 0.0, pos=rec[:, 0:3],
                            conf=rec[:, 3], color=rec[:, 4:7],
                            normal=rec[:, 7:10], radius=rec[:, 10])
    new = _new_surfels(raw, filt, is_new, rgb, static_prob, pose, t_par,
                       config)
    S_tex = (cam.height * F) * (cam.width * F)
    flat = torch.where(ok, local.v4 * (cam.width * F) + local.u4,
                       torch.full_like(local.u4, S_tex))
    return SparseAssoc(updates=updates, new=new, best_id=best_id,
                       matched=matched, active=active, is_winner=is_win,
                       flat=flat)


def lifecycle_and_insert(smap: SurfelMap, killed: torch.Tensor,
                         new: NewSurfels, tick: torch.Tensor,
                         config: SFConfig) -> SurfelMap:
    """Elementwise lifecycle (copy_unstable.vert:118-124), the window-kill
    verdicts, and the new-unstable append at the high-water mark."""
    fus = config.fusion
    dev = smap.pos.device
    tickf = tick.to(torch.float32)
    keep = smap.valid & ~killed
    too_old_unstable = (((tickf - smap.last_time) > fus.clean_unstable_age)
                        & (smap.conf < fus.clean_unstable_conf))
    keep = keep & ~(too_old_unstable | (smap.conf == 0.0))
    stale_stable = (smap.last_time > 0) & \
        ((tickf - smap.last_time) > fus.time_delta)
    keep = (keep | (smap.valid & stale_stable)) & smap.valid

    max_new = new.is_new.shape[0]
    cap = smap.capacity
    rank = torch.cumsum(new.is_new.to(torch.int64), dim=0) - 1
    slot = smap.used.to(torch.int64) + rank
    ins = new.is_new & (slot < cap)
    tgt_ins = torch.where(ins, slot, torch.full_like(slot, cap))
    n_new = rank[-1] + 1 if max_new > 0 else torch.zeros((), device=dev)
    used = torch.clamp(smap.used + n_new, max=cap).to(torch.int32)

    col = lambda a: a[:, None]
    tick_col = tickf.expand(max_new, 1)
    payload_ins = torch.cat([
        new.pos, col(new.conf), new.color, torch.ones((max_new, 1),
                                                      device=dev),
        tick_col, tick_col, new.normal, col(new.radius),
        col(ins.to(torch.float32))], dim=1)
    out = torch.cat([torch.cat([pack_rows(smap),
                                col(keep.to(torch.float32))], dim=1),
                     torch.zeros((1, 15), device=dev)])
    out.index_copy_(0, tgt_ins, payload_ins)
    out = out[:cap]
    return unpack_rows(out[:, :14], out[:, 14] > 0.5, used)
