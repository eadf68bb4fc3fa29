"""Offline visualization: the reference GUI's image panels (port of
staticfusion_tpu/viz/offline.py).

Reference panels (Utils/GUI.h:87-99, Reconstruction.cpp:734-760): RGB, depth
norm, static-probability weights (red=dynamic, blue=static), cluster labels.
Every panel is NumPy and takes tensors on any device (copied to the host)
or arrays; the bytes are the JAX package's.  `save_frame_panels` writes the
2x2 mosaic as one PNG through the port's own encoder: no plotting library
is needed, where the JAX package draws a titled matplotlib figure.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from staticfusion_tpu_torch.io.png import write_png


def host_array(x) -> np.ndarray:
    """`x` as a NumPy array: a tensor on any device is copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def weight_panel(static_prob, depth_mm) -> np.ndarray:
    """(H, W, 3) uint8: red->blue static probability, black where no depth
    (Reconstruction.cpp:740-746)."""
    w = np.clip(host_array(static_prob), 0.0, 1.0)
    has = host_array(depth_mm) > 0
    img = np.zeros(w.shape + (3,), np.uint8)
    img[..., 0] = np.where(has, (255 * (1.0 - w)).astype(np.uint8), 0)
    img[..., 2] = np.where(has, (255 * w).astype(np.uint8), 0)
    return img


def label_panel(labels, num_clusters: int = 24) -> np.ndarray:
    """Grayscale cluster labels (Reconstruction.cpp:751-753)."""
    g = (255 * host_array(labels) / num_clusters).astype(np.uint8)
    return np.stack([g] * 3, axis=-1)


def depth_panel(depth_mm, max_depth_m: float = 4.5) -> np.ndarray:
    """1 - d/max grayscale (depth_norm.frag)."""
    d = host_array(depth_mm) / 1000.0
    g = np.where(d > 0, 1.0 - np.clip(d / max_depth_m, 0, 1), 0.0)
    g8 = (255 * g).astype(np.uint8)
    return np.stack([g8] * 3, axis=-1)


def compose_panels(rgb, depth_mm, static_prob, labels,
                   model: Optional[np.ndarray] = None,
                   model_img: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 mosaic: rgb | depth [| model] // weights | labels [| modelimg].

    `model` is the fused-map render (the reference GUI's Model panel) and
    `model_img` the predicted view (ModelImg, Utils/GUI.h:87-99); when
    neither is given the layout stays 2x2.  `static_prob` and `labels`
    may be None (a blank panel)."""
    rgb8 = host_array(rgb)
    if rgb8.dtype != np.uint8:
        rgb8 = (np.clip(rgb8, 0.0, 1.0) * 255).astype(np.uint8)
    d8 = depth_panel(depth_mm)
    h, w = rgb8.shape[:2]
    blank = np.zeros((h, w, 3), np.uint8)
    w8 = (weight_panel(static_prob, depth_mm)
          if static_prob is not None else blank)
    l8 = label_panel(labels) if labels is not None else blank
    top = [rgb8, d8]
    bot = [w8, l8]
    if model is not None or model_img is not None:
        top.append(model if model is not None else blank)
        bot.append(model_img if model_img is not None else blank)
    return np.concatenate([np.concatenate(top, axis=1),
                           np.concatenate(bot, axis=1)], axis=0)


def save_frame_panels(path: str, rgb, depth_mm, out) -> None:
    """The 2x2 mosaic rgb | depth // static prob | clusters of one frame
    (`out`: a StepOutputs) as a PNG at `path`."""
    write_png(path, compose_panels(rgb, depth_mm, out.static_prob,
                                   out.labels))
