"""Checkpoint/resume of the full SLAM state (port of
staticfusion_tpu/utils/checkpoint.py, same npz layout).

The npz holds `n` and `leaf_0..leaf_{n-1}`, the SlamState's leaves in the
JAX package's `tree_flatten` order (fields in declaration order, nested
tuples depth first); `config_json`, the config as UTF-8 bytes; and, when
an archive is saved, `n_archive` and `arch_i`, the archived SurfelMap's
leaves.  A checkpoint written by either package loads in the other.

The config used at save time is validated on load: restoring under a
different config would rebuild the state around wrong shapes, so a
mismatch raises with the differing fields named.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.fusion.surfels import SurfelMap
from staticfusion_tpu_torch.pipeline.state import (SlamState, n_leaves,
                                                   state_from_numpy,
                                                   tree_from_leaves)


def _leaves(node) -> list:
    """The leaves of a NamedTuple tree, depth first (tree_flatten order),
    as host numpy arrays."""
    if isinstance(node, tuple):
        return [x for v in node for x in _leaves(v)]
    if hasattr(node, "detach"):
        return [node.detach().cpu().numpy()]
    return [np.asarray(node)]


def _config_diff(a: dict, b: dict, prefix: str = "") -> list:
    keys = sorted(set(a) | set(b))
    out = []
    for k in keys:
        va, vb = a.get(k), b.get(k)
        if isinstance(va, dict) and isinstance(vb, dict):
            out += _config_diff(va, vb, prefix + k + ".")
        elif va != vb:
            out.append(f"{prefix}{k}: saved={va!r} vs given={vb!r}")
    return out


def save_state(path: str, state: SlamState,
               config: Optional[SFConfig] = None,
               archive: Optional[SurfelMap] = None) -> None:
    """`archive` is the SlamSystem's stale-surfel store
    (pipeline/system.py), saved alongside so a resumed run keeps the whole
    world."""
    leaves = _leaves(state)
    extra = {}
    if config is not None:
        extra["config_json"] = np.frombuffer(config.to_json().encode(),
                                             dtype=np.uint8)
    if archive is not None:
        a_leaves = _leaves(archive)
        extra["n_archive"] = np.asarray(len(a_leaves))
        extra.update({f"arch_{i}": x for i, x in enumerate(a_leaves)})
    np.savez_compressed(path, n=len(leaves),
                        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
                        **extra)


def _tree(cls, data, count_key: str, leaf_prefix: str):
    """`cls` from the npz leaves `{leaf_prefix}0..`, whose count must be
    the number of leaves `cls` has."""
    n, want = int(data[count_key]), n_leaves(cls)
    if n != want:
        raise ValueError(f"checkpoint holds {n} {cls.__name__} leaves "
                         f"({count_key}), the port's {cls.__name__} has "
                         f"{want}")
    return tree_from_leaves(
        cls, iter([data[f"{leaf_prefix}{i}"] for i in range(n)]))


def load_config(path: str) -> Optional[SFConfig]:
    """The config stored in the checkpoint, or None if it holds none."""
    data = np.load(path)
    if "config_json" not in data:
        return None
    return SFConfig.from_json(bytes(data["config_json"].tobytes()).decode())


def load_state(path: str, config: Optional[SFConfig] = None,
               device="cuda") -> SlamState:
    """Restore a SlamState on `device` (the card unless the caller asks for
    the CPU).  If `config` is given and the checkpoint stored one, they
    must match, except for the map capacity, which the host re-tiers at
    run time (SlamSystem._maybe_resize_map)."""
    data = np.load(path)
    if config is not None and "config_json" in data:
        saved = json.loads(bytes(data["config_json"].tobytes()).decode())
        given = json.loads(config.to_json())
        saved.get("fusion", {}).pop("capacity", None)
        given.get("fusion", {}).pop("capacity", None)
        diff = _config_diff(saved, given)
        if diff:
            raise ValueError(
                "checkpoint config does not match the given config:\n  "
                + "\n  ".join(diff))
    return state_from_numpy(_tree(SlamState, data, "n", "leaf_"), device)


def load_archive(path: str, device="cuda") -> Optional[SurfelMap]:
    """The archived-surfel map stored by save_state, or None."""
    data = np.load(path)
    if "n_archive" not in data:
        return None
    return state_from_numpy(_tree(SurfelMap, data, "n_archive", "arch_"),
                            device, cls=SurfelMap)
