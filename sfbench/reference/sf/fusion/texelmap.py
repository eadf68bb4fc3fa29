"""Frozen copy of staticfusion_tpu_torch/fusion/texelmap.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Texel-space surfel render (port of the parts of
staticfusion_tpu/fusion/texelmap.py on the per-frame path).

Up to 21 id bits, ONE packed-key scatter-min picks each texel's winning
surfel: key = (quantised_depth << id_bits) | surfel_id.  Above that (the
reference's 2^23-surfel map, GlobalModel.cpp:21-22) the render switches to
an exact two-pass z-buffer: a scatter-min of the float32 depth bits viewed
as int32 (positive floats order like their bit patterns), then a
scatter-min of ids over the surfels whose bits equal their texel's
winner.  A min is order-free, so either render is deterministic on CUDA
too, and depth ties go to the smaller id.  Every scatter/gather buffer
carries one sentinel slot past the end: "no target" routes there (JAX
drops such indices) and is sliced off.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.fusion.surfels import SurfelMap
from sfbench.reference.sf.geometry.se3 import se3_inverse

INT_MAX = 2**31 - 1
INVALID = INT_MAX  # "no surfel" id (staticfusion_tpu/ops/zbuffer.py)
# Packed keys leave (31 - id_bits) depth bits: >= 10 up to 21 id bits
# (about 4.4 mm buckets over 4.5 m).  Above it the two-pass z-buffer
# orders by exact float32 depth.
PACKED_MAX_ID_BITS = 21
# Texel coordinates are clamped to +-2^30 before the integer conversion:
# anything that far out is culled either way, and the clamp keeps the
# conversion defined for near-zero depths.
_COORD_CLAMP = float(1 << 30)


def id_bits_for(capacity: int) -> int:
    b = max(1, math.ceil(math.log2(capacity + 1)))
    if b >= 31:
        raise ValueError(f"capacity {capacity} too large for int32 surfel "
                         "ids")
    return b


class TexelImages(NamedTuple):
    """Winner-surfel attributes per texel (camera-local frame)."""
    idx: torch.Tensor   # (Ht, Wt) int64 surfel index, INT_MAX if empty
    has: torch.Tensor   # (Ht, Wt) bool
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    radius: torch.Tensor
    conf: torch.Tensor
    init_time: torch.Tensor
    last_time: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    hist: torch.Tensor


class SurfelsLocal(NamedTuple):
    pos: torch.Tensor     # (N, 3) camera frame
    normal: torch.Tensor  # (N, 3)
    u4: torch.Tensor      # (N,) int64 texel column
    v4: torch.Tensor
    x4c: torch.Tensor     # (N,) continuous texel coords
    y4c: torch.Tensor


def project_surfels(smap: SurfelMap, pose: torch.Tensor,
                    config: SFConfig) -> SurfelsLocal:
    """The map in camera coordinates."""
    cam = config.camera
    F = config.fusion.index_factor
    T_inv = se3_inverse(pose)
    R, t = T_inv[:3, :3], T_inv[:3, 3]
    local = smap.pos @ R.T + t
    local_nrm = smap.normal @ R.T
    z = local[:, 2]
    safe_z = torch.where(z == 0.0, torch.ones_like(z), z)
    x4c = F * (cam.fx * local[:, 0] / safe_z + cam.cx)
    y4c = F * (cam.fy * local[:, 1] / safe_z + cam.cy)

    def to_int(c):
        return torch.floor(torch.clamp(c, -_COORD_CLAMP, _COORD_CLAMP)).to(
            torch.int64)

    return SurfelsLocal(pos=local, normal=local_nrm, u4=to_int(x4c),
                        v4=to_int(y4c), x4c=x4c, y4c=y4c)


def render_cull(smap: SurfelMap, local: SurfelsLocal, tick: torch.Tensor,
                config: SFConfig, conf_threshold: float = 0.0,
                z_min: float = 0.0,
                time_delta: float | None = None) -> torch.Tensor:
    """(capacity,) bool — surfels that enter the z-buffer render
    (index_map.vert:48-56 culls).  `time_delta` overrides the config's
    freshness window (None keeps it; viz passes inf)."""
    cam = config.camera
    fus = config.fusion
    F = fus.index_factor
    td = fus.time_delta if time_delta is None else time_delta
    z = local.pos[:, 2]
    fresh = (tick.to(torch.float32) - smap.last_time) <= td
    return (smap.valid & fresh & (z > z_min) & (z <= fus.depth_max)
            & (smap.conf >= conf_threshold)
            & (local.u4 >= 0) & (local.u4 < cam.width * F)
            & (local.v4 >= 0) & (local.v4 < cam.height * F))


def packed_keys(values: torch.Tensor, cap: float, ib: int,
                base: int = 0) -> torch.Tensor:
    """(quantised value << ib) | id for ids base..base+N-1, values clipped
    to [0, cap] after truncation toward zero."""
    dlevels = (1 << (31 - ib)) - 1
    q = torch.clamp((values * (dlevels / cap)).to(torch.int64), 0, dlevels)
    ids = base + torch.arange(values.shape[0], device=values.device)
    return (q << ib) | ids


def scatter_min(target: torch.Tensor, keys: torch.Tensor,
                n: int) -> torch.Tensor:
    """(n+1,) int64 buffer of per-target key minima (INT_MAX where empty);
    target n is the sentinel, reset to INT_MAX so gathers through it read
    "empty" (JAX: scatter mode="drop", gather mode="fill")."""
    buf = torch.full((n + 1,), INT_MAX, dtype=torch.int64,
                     device=keys.device)
    buf.scatter_reduce_(0, target, keys, "amin", include_self=True)
    buf[n] = INT_MAX
    return buf


def zbuffer(target: torch.Tensor, values: torch.Tensor, cap: float,
            ib: int, n: int, base: int = 0):
    """Per-slot minimum of non-negative float32 `values` over elements
    base..base+N-1 routed to `target` (n = no slot), ties to the smaller
    index.  Returns (buf, key, winner): buf (n+1,) the per-slot minimum
    key, key (N,) each element's key (buf[target] == key marks the
    winners), winner (n,) the winning index per slot, INT_MAX where empty.

    Up to PACKED_MAX_ID_BITS id bits one scatter-min of packed keys
    (values quantised over [0, cap]); above, two: the float32 bits viewed
    as int32, then the indices of the elements whose bits equal their
    slot's minimum."""
    if ib <= PACKED_MAX_ID_BITS:
        key = packed_keys(values, cap, ib, base)
        buf = scatter_min(target, key, n)
        winner = torch.where(buf[:n] != INT_MAX, buf[:n] & ((1 << ib) - 1),
                             buf[:n])
        return buf, key, winner
    bits = values.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64)
    best = scatter_min(target, bits, n)
    target2 = torch.where(bits == best[target], target,
                          torch.full_like(target, n))
    key = base + torch.arange(values.shape[0], device=values.device)
    buf = scatter_min(target2, key, n)
    return buf, key, buf[:n]


def scatter_winner_rows(won: torch.Tensor, flat: torch.Tensor,
                        rows: torch.Tensor, S: int, base: int = 0):
    """(idx, has, attrs): each winning surfel writes its id and its
    (N, C) attribute row to its texel (unique targets, so the writes are
    deterministic).  idx (S,) int64, INT_MAX where no surfel won; attrs
    (C, S), 0 there.  The id goes through an int64 buffer of its own, so
    it stays exact at any capacity."""
    dev = rows.device
    tgt = torch.where(won, flat, torch.full_like(flat, S))
    out = torch.zeros((S + 1, rows.shape[1]), device=dev)
    out.index_copy_(0, tgt, rows.contiguous())
    idx = torch.full((S + 1,), INT_MAX, dtype=torch.int64, device=dev)
    idx.index_copy_(0, tgt, base + torch.arange(rows.shape[0], device=dev))
    idx, out = idx[:S], out[:S]
    return idx, idx != INT_MAX, out.T


def render_texel_images(smap: SurfelMap, local: SurfelsLocal,
                        tick: torch.Tensor, config: SFConfig,
                        conf_threshold: float = 0.0,
                        z_min: float = 0.0,
                        time_delta: float | None = None,
                        materialize: str = "auto") -> TexelImages:
    """Z-buffered surfel render + attribute images, culled as
    `render_cull` (`time_delta` None keeps the config's freshness window;
    viz passes inf, as the GL draw passes render the whole map).  `materialize`
    "gather" reads the attributes at the winner ids (texel-count bound),
    "scatter" has each winning surfel write its row to its texel
    (capacity bound); "auto" gathers when the texel grid is at most twice
    the map's capacity.  Both give the same images."""
    cam = config.camera
    fus = config.fusion
    F = fus.index_factor
    rows4, cols4 = cam.height * F, cam.width * F
    S = rows4 * cols4

    ok = render_cull(smap, local, tick, config, conf_threshold, z_min,
                     time_delta)
    flat = torch.where(ok, local.v4 * cols4 + local.u4,
                       torch.full_like(local.u4, S))
    cap, base = smap.capacity, 0
    buf, key, winner = zbuffer(flat, local.pos[:, 2], fus.depth_max,
                               id_bits_for(cap), S, base)
    has = winner != INT_MAX

    stacked = torch.stack([
        local.pos[:, 0], local.pos[:, 1], local.pos[:, 2],
        local.normal[:, 0], local.normal[:, 1], local.normal[:, 2],
        smap.radius, smap.conf, smap.init_time, smap.last_time,
        smap.color[:, 0], smap.color[:, 1], smap.color[:, 2], smap.hist])
    use_gather = (S <= 2 * smap.capacity if materialize == "auto"
                  else materialize == "gather")
    if use_gather:
        safe = torch.where(has, winner, torch.zeros_like(winner))
        attrs = torch.where(has[None, :], stacked[:, safe],
                            torch.zeros((), device=key.device))
        idx = winner
    else:
        idx, _, attrs = scatter_winner_rows(ok & (buf[flat] == key), flat,
                                            stacked.T, S, base)
    img = lambda a: a.reshape(rows4, cols4)
    return TexelImages(img(idx), img(has),
                       *[img(attrs[i]) for i in range(14)])


def window_offsets(F: int) -> range:
    """Texel offsets around the pixel's base texel F*u covering the
    reference's ~+-0.5 px search reach (data.vert window [4u-2, 4u+5] at
    F=4)."""
    w = max(1, F // 2)
    return range(-w, w + F)


def phase_decompose(img: torch.Tensor, F: int) -> torch.Tensor:
    """(H*F, W*F) -> (F, F, H, W): phase[sv, su][v, u] = img[F v + sv,
    F u + su]."""
    H4, W4 = img.shape
    return img.reshape(H4 // F, F, W4 // F, F).permute(1, 3, 0, 2)


def phase_window(phases: torch.Tensor, dv: int, du: int,
                 F: int) -> torch.Tensor:
    """Texel (F v + dv, F u + du) for every pixel (v, u); out-of-range
    texels are zero."""
    sv, bv = dv % F, dv // F
    su, bu = du % F, du // F
    img = phases[sv, su]
    if bv == 0 and bu == 0:
        return img
    H, W = img.shape
    a = max(abs(bv), abs(bu))
    p = torch.nn.functional.pad(img, (a, a, a, a))
    return p[a + bv:a + bv + H, a + bu:a + bu + W]
