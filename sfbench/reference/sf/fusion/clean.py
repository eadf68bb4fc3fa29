"""Frozen copy of staticfusion_tpu_torch/fusion/clean.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Map cleaning (port of window_kill_tex, kill_mask_from_tex and
writeback_and_insert in staticfusion_tpu/fusion/clean.py; reference
copy_unstable.vert): the window test as a stencil over texel attribute
images, and the texel fuse's write-back of merged texels with the
lifecycle kills and the new-surfel insert."""

from __future__ import annotations

import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.fusion.association import NewSurfels
from sfbench.reference.sf.fusion.surfels import (SurfelMap,
                                                   append_at_watermark)
from sfbench.reference.sf.fusion.texelmap import SurfelsLocal, TexelImages


def _axis_weight(off: int, frac: torch.Tensor, F: int) -> torch.Tensor:
    """How many of the 16 window samples land on texel (own + off), given
    the projection's fractional texel coordinate `frac` in [0,1)."""
    s = 8.0 / F
    lo = torch.ceil(torch.clamp(s * (off - frac + F), min=0.0))
    hi = torch.ceil(torch.clamp(s * (off + 1 - frac + F), max=16.0))
    return torch.clamp(hi - lo, min=0.0)


def window_kill_tex(tex: TexelImages, tick: torch.Tensor,
                    config: SFConfig) -> torch.Tensor:
    """(Ht, Wt) bool — texels whose winner the copy_unstable window test
    kills (redundant behind an older confident surfel, or a free-space
    violator behind it)."""
    fus = config.fusion
    tickf = tick.to(torch.float32)
    F = fus.index_factor
    R = F  # the +-1 px sample reach is +-F texels
    self_z, self_x, self_y = tex.z, tex.x, tex.y
    self_init = tex.init_time
    rad2 = (tex.radius * 1.4) ** 2
    cam = config.camera
    safe_z = torch.where(self_z == 0.0, torch.ones_like(self_z), self_z)
    x4 = F * (cam.fx * self_x / safe_z + cam.cx)
    y4 = F * (cam.fy * self_y / safe_z + cam.cy)
    fx_ = x4 - torch.floor(x4)
    fy_ = y4 - torch.floor(y4)

    pad = lambda a: torch.nn.functional.pad(a, (R, R, R, R))
    pads = {k: pad(getattr(tex, k)) for k in
            ("z", "conf", "init_time", "last_time", "x", "y")}
    p_has = pad(tex.has)
    rows4, cols4 = tex.z.shape

    def sl(img, dy, dx):
        return img[R + dy:R + dy + rows4, R + dx:R + dx + cols4]

    count = torch.zeros_like(self_z)
    zcount = torch.zeros_like(self_z)
    zero = torch.zeros_like(self_z)
    for dy in range(-F, F + 1):
        wy = _axis_weight(dy, fy_, F)
        for dx in range(-F, F + 1):
            w = _axis_weight(dx, fx_, F) * wy
            c_has = sl(p_has, dy, dx)
            cz = sl(pads["z"], dy, dx)
            c_conf = sl(pads["conf"], dy, dx)
            d2 = ((sl(pads["x"], dy, dx) - self_x) ** 2
                  + (sl(pads["y"], dy, dx) - self_y) ** 2)
            behind = cz > self_z
            red = (c_has & (sl(pads["init_time"], dy, dx) < self_init)
                   & (c_conf > fus.confidence_threshold)
                   & behind & (cz - self_z < 0.01) & (d2 < rad2))
            fsv = (c_has & (sl(pads["last_time"], dy, dx) == tickf)
                   & (c_conf > 0.4 * fus.confidence_threshold)
                   & behind & (cz - self_z > 0.01))
            count = count + torch.where(red, w, zero)
            zcount = zcount + torch.where(fsv, w, zero)
    # Thresholds count window samples; one neighbour collects up to
    # (8/F)^2 of them, so scale to keep their meaning at any F.
    mult = (4.0 / F) ** 2
    return tex.has & ((count > fus.clean_redundant_count * mult)
                      | (zcount > fus.clean_free_space_count * mult))


def kill_mask_from_tex(kill_tex: torch.Tensor, idx: torch.Tensor,
                       capacity: int, base: int = 0) -> torch.Tensor:
    """Texel kill verdicts -> (capacity,) mask of slots base..base +
    capacity - 1; non-killing texels (and those of other slots) route to
    the sentinel slot `capacity`."""
    own = idx.reshape(-1) - base
    mine = kill_tex.reshape(-1) & (own >= 0) & (own < capacity)
    tgt = torch.where(mine, own, torch.full_like(own, capacity))
    killed = torch.zeros(capacity + 1, dtype=torch.bool, device=idx.device)
    killed[tgt] = True
    return killed[:capacity]


def writeback_and_insert(smap: SurfelMap, merged: TexelImages,
                         upd_has: torch.Tensor, kill_tex: torch.Tensor,
                         local: SurfelsLocal, new: NewSurfels,
                         pose: torch.Tensor, tick: torch.Tensor,
                         config: SFConfig) -> SurfelMap:
    """The texel fuse's map update, in three disjoint write classes:

    * elementwise: the age and zero-confidence kills on every slot
      (copy_unstable.vert:118-122), with stable surfels outside the update
      window always retained;
    * write-back: a slot whose texel it won was updated or window-killed
      takes the merged attributes (converted to world) or dies.  It runs
      surfel-major: each slot reads its own texel through the projection
      `local` that produced the render and takes the row iff it is that
      texel's winner;
    * insert: new unstable surfels append at the `used` high-water mark.

    Write-back targets are render winners (valid, in [0, used)); inserts
    go to [used, capacity)."""
    fus = config.fusion
    cam = config.camera
    F = fus.index_factor
    rows4, cols4 = cam.height * F, cam.width * F
    tickf = tick.to(torch.float32)
    cap = smap.capacity

    too_old_unstable = (((tickf - smap.last_time) > fus.clean_unstable_age)
                        & (smap.conf < fus.clean_unstable_conf))
    keep_elem = smap.valid & ~(too_old_unstable | (smap.conf == 0.0))
    stale_stable = (smap.last_time > 0) & \
        ((tickf - smap.last_time) > fus.time_delta)
    keep_elem = (keep_elem | (smap.valid & stale_stable)) & smap.valid

    wb = merged.has & (upd_has | kill_tex)
    inb = ((local.u4 >= 0) & (local.u4 < cols4)
           & (local.v4 >= 0) & (local.v4 < rows4))
    fi = (torch.clamp(local.v4, 0, rows4 - 1) * cols4
          + torch.clamp(local.u4, 0, cols4 - 1))
    tab = torch.stack([
        merged.x, merged.y, merged.z, merged.conf, merged.r, merged.g,
        merged.b, merged.hist, merged.init_time, merged.last_time,
        merged.nx, merged.ny, merged.nz, merged.radius,
        kill_tex.to(torch.float32)], dim=-1).reshape(-1, 15)
    g = tab[fi]                                              # (cap, 15)
    writer = torch.where(wb, merged.idx,
                         torch.full_like(merged.idx, -1)).reshape(-1)[fi]
    base = 0
    take = inb & (writer == base + torch.arange(cap, device=writer.device))

    R, t = pose[:3, :3], pose[:3, 3]
    t3 = take[:, None]
    sel = lambda i, old: torch.where(take, g[:, i], old)
    rows = torch.cat([
        torch.where(t3, g[:, 0:3] @ R.T + t, smap.pos),
        sel(3, smap.conf)[:, None],
        torch.where(t3, g[:, 4:7], smap.color),
        sel(7, smap.hist)[:, None], sel(8, smap.init_time)[:, None],
        sel(9, smap.last_time)[:, None],
        torch.where(t3, g[:, 10:13] @ R.T, smap.normal),
        sel(13, smap.radius)[:, None]], dim=1)
    keep = torch.where(take, g[:, 14] < 0.5, keep_elem)
    return append_at_watermark(rows, keep, smap.used, new, tickf)
