"""Surfel-map rendering from arbitrary viewpoints (port of
staticfusion_tpu/viz/render.py) — the offline equivalent of the reference
GUI's model draw passes.

Reference: `GlobalModel::renderPointCloud` + `draw_global_surface.{vert,geom,
frag}` (color modes: RGB / normals / times / confidence),
`draw_global_surface_phong.frag` (headlight shading), and
`IndexMap::renderDepth` (depth_norm-style normalized depth).  The disk-splat
rasterization is the prediction path's (fusion/predict.py), run on the
map's device; `colorize` moves the view to the host once and is NumPy from
there, with the JAX package's bytes for the same view.
"""

from __future__ import annotations

import numpy as np
import torch

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion.predict import (PredictedView,
                                                   splat_from_texels)
from staticfusion_tpu_torch.fusion.surfels import SurfelMap
from staticfusion_tpu_torch.fusion.texelmap import (project_surfels,
                                                    render_texel_images)
from staticfusion_tpu_torch.viz.offline import host_array

MODES = ("rgb", "normal", "phong", "time", "conf", "depth")


def render_view(smap: SurfelMap, pose, conf_threshold: float,
                config: SFConfig) -> PredictedView:
    """Splat the whole map (no freshness window — the GL draw passes render
    every surfel) into the camera at `pose` (4x4 tensor or array, moved to
    the map's device)."""
    dev = smap.pos.device
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    local = project_surfels(smap, pose, config)
    tex = render_texel_images(smap, local,
                              torch.zeros((), dtype=torch.int32, device=dev),
                              config, conf_threshold=conf_threshold,
                              z_min=config.fusion.predict_z_min,
                              time_delta=float("inf"))
    return splat_from_texels(tex, config)


def _turbo_like(x: np.ndarray) -> np.ndarray:
    """Small smooth blue->green->red ramp for time coloring (stands in for
    the GL time gradient)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return np.stack([r, g, b], axis=-1)


def view_to_host(view: PredictedView) -> PredictedView:
    """The view with every field a NumPy array (one copy per field)."""
    return PredictedView(*(host_array(f) for f in view))


def colorize(view: PredictedView, mode: str, config: SFConfig) -> np.ndarray:
    """(H, W, 3) uint8 panel from a rendered view (tensors on any device,
    or a `view_to_host` copy when several modes color one view).

    Modes mirror the reference draw options (Utils/GUI.h draw checkboxes +
    draw_global_surface.frag color branches): rgb, normal (0.5+0.5n),
    phong (headlight diffuse+ambient on the surfel color), time (init-time
    ramp), conf (confidence grayscale), depth (1 - z/maxDepth,
    depth_norm.frag)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    view = view_to_host(view)
    hit = view.depth > 0.0
    h3 = hit[..., None]
    if mode == "rgb":
        img = np.clip(view.image, 0.0, 1.0)
    elif mode == "normal":
        img = 0.5 + 0.5 * view.normal
    elif mode == "phong":
        n = view.normal
        v = view.vertex
        ray = -v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        diff = np.abs(np.sum(n * ray, axis=-1))[..., None]
        base = np.clip(view.image, 0.0, 1.0)
        img = np.clip(0.3 * base + 0.7 * base * diff + 0.1 * diff, 0.0, 1.0)
    elif mode == "time":
        t = view.time
        tmax = max(float(t.max()), 1.0)
        img = _turbo_like(t / tmax)
    elif mode == "conf":
        c = np.clip(view.conf, 0.0, 1.0)[..., None]
        img = np.repeat(c, 3, axis=-1)
    else:  # depth
        d = view.depth
        g = np.where(hit, 1.0 - np.clip(d / config.fusion.depth_max, 0, 1),
                     0.0)[..., None]
        img = np.repeat(g, 3, axis=-1)
    img = np.where(h3, img, 0.0)
    return (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)


def render_map(smap: SurfelMap, pose, config: SFConfig, mode: str = "rgb",
               conf_threshold: float = 0.0) -> np.ndarray:
    """One-call viewpoint render -> uint8 image."""
    return colorize(render_view(smap, pose, conf_threshold, config), mode,
                    config)
