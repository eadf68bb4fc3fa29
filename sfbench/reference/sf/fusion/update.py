"""Frozen copy of staticfusion_tpu_torch/fusion/update.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Merge update records into the surfel map (port of
staticfusion_tpu/fusion/update.py; reference update.vert): log-odds
confidence fusion and weighted averaging of position/colour/normal, gated
by the radius-growth test (newRadius < 1.5 oldRadius).  `apply_updates`
merges slot-space records (the sparse fuse), `merge_texels` texel-routed
ones into the texel images (the texel fuse)."""

from __future__ import annotations

import torch

from sfbench.reference.sf.fusion.association import (TexelUpdates,
                                                       UpdateRecords)
from sfbench.reference.sf.fusion.surfels import SurfelMap
from sfbench.reference.sf.fusion.texelmap import TexelImages


def apply_updates(smap: SurfelMap, upd: UpdateRecords,
                  tick: torch.Tensor) -> SurfelMap:
    m = upd.has_update & smap.valid
    c_k = torch.clamp(smap.conf, 0.01, 0.99)
    a = torch.clamp(2.0 * upd.conf * upd.conf, 0.01, 0.53)  # update.vert:66
    ltm = torch.log(1.0 / (1.0 - c_k) - 1.0) + torch.log(a / (1.0 - a))
    c_k1 = 1.0 - 1.0 / (1.0 + torch.exp(ltm))

    merge = m & (upd.radius < 1.5 * smap.radius)  # update.vert:73
    w_old = smap.hist * c_k
    denom = torch.clamp(w_old + a, min=1e-12)

    def blend(old, new):
        return (w_old[:, None] * old + a[:, None] * new) / denom[:, None]

    nr = blend(smap.normal, upd.normal)
    nr = nr / torch.clamp(torch.linalg.vector_norm(nr, dim=-1, keepdim=True),
                          min=1e-12)
    sel3 = lambda cond, new, old: torch.where(cond[:, None], new, old)
    return smap._replace(
        pos=sel3(merge, blend(smap.pos, upd.pos), smap.pos),
        color=sel3(merge, blend(smap.color, upd.color), smap.color),
        normal=sel3(merge, nr, smap.normal),
        radius=torch.where(merge, (w_old * smap.radius + a * upd.radius)
                           / denom, smap.radius),
        conf=torch.where(m, c_k1, smap.conf),
        hist=torch.where(m, smap.hist + 1.0, smap.hist),
        last_time=torch.where(m, tick.to(torch.float32), smap.last_time))


def merge_texels(tex: TexelImages, upd: TexelUpdates,
                 tick: torch.Tensor) -> TexelImages:
    """update.vert in texel space: the winner-surfel attribute images merge
    elementwise with the texel-routed records (camera frame; the
    write-back converts to world once).  Same math as apply_updates."""
    m = upd.has & tex.has
    c_k = torch.clamp(tex.conf, 0.01, 0.99)
    a = torch.clamp(2.0 * upd.conf * upd.conf, 0.01, 0.53)  # update.vert:66
    ltm = torch.log(1.0 / (1.0 - c_k) - 1.0) + torch.log(a / (1.0 - a))
    c_k1 = 1.0 - 1.0 / (1.0 + torch.exp(ltm))

    merge = m & (upd.radius < 1.5 * tex.radius)  # update.vert:73
    w_old = tex.hist * c_k
    denom = torch.clamp(w_old + a, min=1e-12)

    def blend(old, new):
        return torch.where(merge, (w_old * old + a * new) / denom, old)

    bx = blend(tex.nx, upd.normal[..., 0])
    by = blend(tex.ny, upd.normal[..., 1])
    bz = blend(tex.nz, upd.normal[..., 2])
    nn = torch.clamp(torch.sqrt(bx * bx + by * by + bz * bz), min=1e-12)
    return tex._replace(
        x=blend(tex.x, upd.pos[..., 0]), y=blend(tex.y, upd.pos[..., 1]),
        z=blend(tex.z, upd.pos[..., 2]),
        # Renormalised on the merge branch only (apply_updates parity).
        nx=torch.where(merge, bx / nn, tex.nx),
        ny=torch.where(merge, by / nn, tex.ny),
        nz=torch.where(merge, bz / nn, tex.nz),
        radius=blend(tex.radius, upd.radius),
        conf=torch.where(m, c_k1, tex.conf),
        hist=torch.where(m, tex.hist + 1.0, tex.hist),
        last_time=torch.where(m, tick.to(torch.float32), tex.last_time),
        r=blend(tex.r, upd.color[..., 0]), g=blend(tex.g, upd.color[..., 1]),
        b=blend(tex.b, upd.color[..., 2]))
