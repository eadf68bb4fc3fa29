"""Frozen copy of staticfusion_tpu_torch/fusion/predict.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Splat prediction, FillIn compositing and the density check (port of
splat_from_texels / dense_enough / composite_prediction /
predict_low_view in staticfusion_tpu/fusion/predict.py; reference
IndexMap::combinedPredict, combo_splat.frag, FillIn,
Reconstruction.cpp:218-233)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.fusion.surfels import SurfelMap, backproject_fusion
from sfbench.reference.sf.fusion.texelmap import (TexelImages,
                                                    phase_decompose,
                                                    phase_window,
                                                    project_surfels,
                                                    render_texel_images,
                                                    window_offsets)


class PredictedView(NamedTuple):
    image: torch.Tensor   # (H, W, 3) rgb, 0 where empty
    vertex: torch.Tensor  # (H, W, 3) camera-frame position
    conf: torch.Tensor    # (H, W)
    normal: torch.Tensor  # (H, W, 3)
    radius: torch.Tensor  # (H, W)
    time: torch.Tensor    # (H, W) surfel init time
    depth: torch.Tensor   # (H, W) corrected z, 0 where empty


def splat_from_texels(tex: TexelImages, config: SFConfig) -> PredictedView:
    """Ray-disk intersection of each pixel's view ray with the window of
    texel candidates (combo_splat.frag math); the nearest hit wins, the
    first in scan order on ties."""
    cam = config.camera
    F = config.fusion.index_factor
    rows, cols = cam.height, cam.width
    dev = tex.z.device
    uu = torch.arange(cols, dtype=torch.float32, device=dev)[None, :] + 0.5
    vv = torch.arange(rows, dtype=torch.float32, device=dev)[:, None] + 0.5
    lx = ((uu - cam.cx) / cam.fx).expand(rows, cols)[None]
    ly = ((vv - cam.cy) / cam.fy).expand(rows, cols)[None]

    names = ("has", "x", "y", "z", "nx", "ny", "nz", "radius", "conf",
             "init_time", "r", "g", "b")
    offs = [(dv, du) for dv in window_offsets(F) for du in window_offsets(F)]
    C = {}
    for name in names:
        img = getattr(tex, name)
        ph = phase_decompose(img.to(torch.float32), F)
        C[name] = torch.stack([phase_window(ph, dv, du, F)
                               for dv, du in offs])

    has = C["has"] > 0
    cx_, cy_, cz = C["x"], C["y"], C["z"]
    cnx, cny, cnz = C["nx"], C["ny"], C["nz"]
    denom = lx * cnx + ly * cny + cnz
    denom = torch.where(torch.abs(denom) < 1e-12,
                        torch.full_like(denom, 1e-12), denom)
    tproj = (cx_ * cnx + cy_ * cny + cz * cnz) / denom
    hx = tproj * lx - cx_
    hy = tproj * ly - cy_
    hz = tproj - cz
    inside = (hx * hx + hy * hy + hz * hz) <= C["radius"] * C["radius"]
    ok = has & inside & (tproj > 0)
    tz = torch.where(ok, tproj, torch.full_like(tproj, float("inf")))
    best_z = torch.amin(tz, dim=0)
    best = torch.argmin(tz, dim=0)           # first in scan order on ties

    def select(name):
        return torch.gather(C[name], 0, best[None])[0]

    hit = torch.isfinite(best_z)
    zc = torch.where(hit, best_z, torch.zeros_like(best_z))
    h3 = hit[..., None]
    z3 = torch.zeros((), device=dev)
    vertex = torch.stack([lx[0] * zc, ly[0] * zc, zc], dim=-1)
    return PredictedView(
        image=torch.where(h3, torch.stack([select("r"), select("g"),
                                           select("b")], -1), z3),
        vertex=torch.where(h3, vertex, z3),
        conf=torch.where(hit, select("conf"), z3),
        normal=torch.where(h3, torch.stack([select("nx"), select("ny"),
                                            select("nz")], -1), z3),
        radius=torch.where(hit, select("radius"), z3),
        time=torch.where(hit, select("init_time"), z3),
        depth=zc)


def dense_enough(image: torch.Tensor, config: SFConfig) -> torch.Tensor:
    """> dense_threshold of a 1/40-scale nearest-sample grid has non-zero
    rgb (Reconstruction.cpp:218-233 on the u8 download)."""
    s = config.fusion.dense_scale
    rows, cols = image.shape[:2]
    sub = image[s // 2:rows - rows % s:s, s // 2:cols - cols % s:s]
    nz = torch.all(torch.round(sub * 255.0) > 0, dim=-1)
    return torch.mean(nz.to(torch.float32)) > config.fusion.dense_threshold


class Prediction(NamedTuple):
    depth: torch.Tensor      # (H, W) predicted depth for the solver
    intensity: torch.Tensor  # (H, W) predicted intensity
    image: torch.Tensor      # (H, W, 3) composited rgb
    dense: torch.Tensor      # scalar bool


def composite_prediction(low: PredictedView, filtered_depth_m: torch.Tensor,
                         rgb: torch.Tensor, static_prob: torch.Tensor,
                         config: SFConfig) -> Prediction:
    """FillIn / density check / depth extraction over the carried LOW
    view.  The HIGH view is the LOW view masked to pixels whose winning
    splat meets the high threshold."""
    fus = config.fusion
    hi_m = low.conf >= fus.confidence_threshold
    hi3 = hi_m[..., None]
    z = torch.zeros((), device=low.depth.device)
    high_image = torch.where(hi3, low.image, z)
    high_vertex = torch.where(hi3, low.vertex, z)
    dense = dense_enough(low.image, config)

    img_empty = lambda im: (torch.sum(im, dim=-1) == 0.0)[..., None]
    vtx_empty = lambda vt: (vt[..., 2] == 0.0)[..., None]

    raw_vertex = backproject_fusion(filtered_depth_m, config)
    raw_fill_vtx = torch.where((static_prob > fus.fillin_static_gate)[..., None],
                               raw_vertex, z)
    v1 = torch.where(vtx_empty(low.vertex), raw_fill_vtx, low.vertex)
    v2_sparse = torch.where(vtx_empty(high_vertex), v1, high_vertex)
    i1 = torch.where(img_empty(low.image), rgb, low.image)
    i2_sparse = torch.where(img_empty(high_image), i1, high_image)
    v2_dense = torch.where(vtx_empty(high_vertex), low.vertex, high_vertex)
    i2_dense = torch.where(img_empty(high_image), low.image, high_image)

    vertex = torch.where(dense, v2_dense, v2_sparse)
    image = torch.where(dense, i2_dense, i2_sparse)
    zc = vertex[..., 2]
    depth = torch.where((zc > 0) & (zc <= fus.depth_max), zc, z)
    rgb_q = torch.round(torch.clamp(image, 0.0, 1.0) * 255.0) / 255.0
    intensity = (0.299 * rgb_q[..., 0] + 0.587 * rgb_q[..., 1]
                 + 0.114 * rgb_q[..., 2])
    return Prediction(depth=depth, intensity=intensity, image=image,
                      dense=dense)


def predict_low_view(smap: SurfelMap, pose: torch.Tensor, tick: torch.Tensor,
                     config: SFConfig) -> PredictedView:
    """Render + splat the LOW-confidence view (bootstrap only; steady
    frames carry the splat from the fuse)."""
    fus = config.fusion
    local = project_surfels(smap, pose, config)
    tex = render_texel_images(smap, local, tick, config,
                              conf_threshold=fus.low_conf,
                              z_min=fus.predict_z_min)
    return splat_from_texels(tex, config)
