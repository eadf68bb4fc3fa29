"""Map cleaning: the copy_unstable window test as a stencil over texel
attribute images (port of window_kill_tex / kill_mask_from_tex in
staticfusion_tpu/fusion/clean.py; reference copy_unstable.vert)."""

from __future__ import annotations

import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion.texelmap import TexelImages


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
                       capacity: int) -> torch.Tensor:
    """Texel kill verdicts -> (capacity,) slot mask; non-killing texels
    route to the sentinel slot `capacity`."""
    tgt = torch.where(kill_tex.reshape(-1), idx.reshape(-1),
                      torch.full_like(idx.reshape(-1), capacity))
    killed = torch.zeros(capacity + 1, dtype=torch.bool, device=idx.device)
    killed[tgt] = True
    return killed[:capacity]
