"""Frozen copy of staticfusion_tpu_torch/fusion/indexmap.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

Index-map predictive render (port of staticfusion_tpu/fusion/indexmap.py;
reference IndexMap::predictIndices, IndexMap.cpp:127-185)."""

from __future__ import annotations

from typing import Tuple

import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.fusion.surfels import SurfelMap
from sfbench.reference.sf.fusion.texelmap import (SurfelsLocal, TexelImages,
                                                    project_surfels,
                                                    render_texel_images)


def predict_indices(smap: SurfelMap, pose: torch.Tensor, tick: torch.Tensor,
                    config: SFConfig
                    ) -> Tuple[TexelImages, SurfelsLocal]:
    """Render surfel ids + attributes into the F x texel grid."""
    local = project_surfels(smap, pose, config)
    return render_texel_images(smap, local, tick, config), local
