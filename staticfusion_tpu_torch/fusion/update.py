"""Merge update records into the surfel map (port of
staticfusion_tpu/fusion/update.py::apply_updates; reference update.vert):
log-odds confidence fusion and weighted averaging of position/colour/
normal, gated by the radius-growth test (newRadius < 1.5 oldRadius)."""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.fusion.association import UpdateRecords
from staticfusion_tpu_torch.fusion.surfels import SurfelMap


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
