"""Frozen copy of staticfusion_tpu_torch/pipeline/state.py for the
benchmark's reference: the plain PyTorch versions only, no CUDA kernel.

The SLAM state carried across frames (port of
staticfusion_tpu/pipeline/state.py), plus conversion to and from trees of
numpy arrays so a port step can start from a state (or a keyframe DB) the
JAX package produced, and back."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.fusion.predict import PredictedView
from sfbench.reference.sf.fusion.surfels import SurfelMap, empty_map


class RingBuffers(NamedTuple):
    """Temporal residual buffers (StaticFusion.h:91-96)."""
    depth: torch.Tensor      # (L, H, W)
    intensity: torch.Tensor  # (L, H, W)
    odom: torch.Tensor       # (L, 4, 4)


class SlamState(NamedTuple):
    smap: SurfelMap
    curr_pose: torch.Tensor          # (4,4) reconstruction pose
    tick: torch.Tensor               # int32 reconstruction frame counter
    im_count: torch.Tensor           # int32 solver frame counter
    twist_old: torch.Tensor          # (6,) previous-frame velocity
    rings: RingBuffers
    prev_rgb: torch.Tensor           # (H, W, 3) previous frame's upload
    prev_filt_depth: torch.Tensor    # (H, W) metric filtered
    prev_static_prob: torch.Tensor   # (H, W)
    per_cluster_residual: torch.Tensor  # (K,) NaN = unset
    pred: PredictedView              # LOW view for the next frame


def empty_view(rows: int, cols: int, device=None) -> PredictedView:
    z2 = torch.zeros((rows, cols), device=device)
    z3 = torch.zeros((rows, cols, 3), device=device)
    return PredictedView(image=z3, vertex=z3, conf=z2, normal=z3, radius=z2,
                         time=z2, depth=z2)


def init_state(config: SFConfig, device=None) -> SlamState:
    rows, cols = config.rows, config.cols
    L = config.buffer_length
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return SlamState(
        smap=empty_map(config.fusion.capacity, device),
        curr_pose=torch.eye(4, device=device),
        tick=i32(1), im_count=i32(0),
        twist_old=torch.zeros(6, device=device),
        rings=RingBuffers(
            depth=torch.zeros((L, rows, cols), device=device),
            intensity=torch.zeros((L, rows, cols), device=device),
            odom=torch.eye(4, device=device).repeat(L, 1, 1)),
        prev_rgb=torch.zeros((rows, cols, 3), device=device),
        prev_filt_depth=torch.zeros((rows, cols), device=device),
        prev_static_prob=torch.zeros((rows, cols), device=device),
        per_cluster_residual=torch.full((config.num_clusters,), float("nan"),
                                        device=device),
        pred=empty_view(rows, cols, device))


_NESTED = {"smap": SurfelMap, "rings": RingBuffers, "pred": PredictedView}


def entry_device(device) -> torch.device:
    """The device of an entry point: the card unless the caller asks for
    the CPU.  Raises when the card is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device=\"cpu\" to run on the CPU")
    return device


def state_from_numpy(tree, device="cuda", cls=SlamState):
    """SlamState (or `cls`: one of its nested types such as SurfelMap, or
    pipeline.keyframes.KeyframeDB) from any tree with the same field names
    whose leaves are numpy arrays (e.g. a JAX SlamState or KeyframeDB
    mapped through np.asarray).  Float leaves become
    float32, integer leaves int32, bool stays bool."""
    device = entry_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int32
        else:
            dt = torch.float32
        return torch.tensor(a, dtype=dt, device=device)  # copies

    def build(cls, node):
        return cls(**{f: (build(_NESTED[f], getattr(node, f))
                          if f in _NESTED else leaf(getattr(node, f)))
                      for f in cls._fields})
    return build(cls, tree)


def tree_from_leaves(cls, leaves):
    """`cls` (SlamState or a nested type) from an iterator over its leaves
    in the JAX package's `tree_flatten` order: fields in declaration
    order, nested tuples depth first.  The leaves are taken as given."""
    return cls(**{f: (tree_from_leaves(_NESTED[f], leaves) if f in _NESTED
                      else next(leaves)) for f in cls._fields})


def n_leaves(cls) -> int:
    """The number of leaves of `cls` (SlamState or a nested type)."""
    return sum(n_leaves(_NESTED[f]) if f in _NESTED else 1
               for f in cls._fields)


def state_to_numpy(state: SlamState) -> SlamState:
    """The same tree (a SlamState, a nested type or a KeyframeDB) with
    every tensor copied to a host numpy array."""
    def conv(node):
        if isinstance(node, torch.Tensor):
            return node.detach().cpu().numpy()
        return type(node)(*[conv(v) for v in node])
    return conv(state)
