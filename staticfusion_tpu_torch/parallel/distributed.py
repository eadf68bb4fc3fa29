"""Multi-process runtime (port of staticfusion_tpu/parallel/distributed.py)
over torch.distributed.

The JAX package joins the JAX distributed service and lets GSPMD run one
program over every process's devices.  Here one process drives one device
(a rank): `initialize()` opens the store the ranks meet through, and
`global_mesh()` builds this rank's Gloo groups over it (parallel/mesh.py).
No default process group is created.

* `lift_to_mesh()` cuts a host-local tree (e.g. the bootstrap state,
  computed identically on every rank) to this rank's blocks.
* `put_frame()` is the per-rank data path: every rank holds the frame as
  a host array, but only its row block goes to the device.

SPMD contract: every rank executes the same sequence of steps on the same
frame stream; per-rank work divides along the mesh axes, and the
collectives (Gloo, through host memory also for CUDA tensors) cross the
process boundaries.  JAX's `cpu_devices_per_process` has no counterpart:
one rank drives one device, so a mesh of n ranks takes n processes (they
may share one card).
"""

from __future__ import annotations

from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.parallel import mesh as mesh_lib
from staticfusion_tpu_torch.pipeline.state import entry_device

# How long a rank waits at the store and in a collective for the others.
TIMEOUT = timedelta(seconds=60)


class Runtime(NamedTuple):
    """What `initialize` sets up for this rank."""
    store: object           # the torch.distributed store the ranks meet at
    num_processes: int
    process_id: int
    device: torch.device
    hostname: str | None    # the address Gloo binds (None: default)


def initialize(store_path: str | None = None, coordinator: str | None = None,
               num_processes: int = 1, process_id: int = 0,
               device="cuda") -> Runtime:
    """Join the ranks: through a FileStore at `store_path` (ranks of one
    host, or a shared file system) or a TCPStore at `coordinator`
    ("host:port", served by process 0).  `device` "cuda" is card
    process_id mod the host's card count; without a card it raises,
    naming device="cpu"."""
    dev = entry_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"{num_processes} processes")
    if (store_path is None) == (coordinator is None):
        raise ValueError("pass one of store_path or coordinator")
    hostname = "127.0.0.1"
    if store_path is not None:
        store = dist.FileStore(store_path, num_processes)
        store.set_timeout(TIMEOUT)
    else:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0, timeout=TIMEOUT)
        if host not in ("localhost", "127.0.0.1"):
            hostname = None
    return Runtime(store, num_processes, process_id, dev, hostname)


def global_mesh(n_pix: int, n_map: int, runtime: Runtime) -> mesh_lib.Mesh:
    """(pix, map) mesh over every rank; n_pix * n_map must equal the
    number of processes."""
    if n_pix * n_map != runtime.num_processes:
        raise ValueError(f"a {n_pix}x{n_map} mesh needs {n_pix * n_map} "
                         f"processes, have {runtime.num_processes}")
    return mesh_lib.make_mesh(n_pix, n_map, runtime.process_id,
                              runtime.store, TIMEOUT, runtime.device,
                              runtime.hostname)


def lift_to_mesh(tree, shardings, mesh: mesh_lib.Mesh):
    """Host-local tree -> this rank's blocks on its device.  Every rank
    must hold identical host values (SPMD: same bootstrap, same frames)."""
    as_tensor = lambda x, _: torch.as_tensor(np.asarray(x))
    host = mesh_lib.map_tree(as_tensor, tree, shardings)
    return mesh_lib.shard_tree(host, shardings, mesh)


def put_state(state, mesh: mesh_lib.Mesh):
    return mesh_lib.shard_tree(state, mesh_lib.state_shardings(), mesh)


def put_frame(frame, mesh: mesh_lib.Mesh):
    return lift_to_mesh(frame, mesh_lib.frame_shardings(), mesh)


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """A step output (whole on every rank) as a host array."""
    return x.detach().cpu().numpy()


class DistributedSlam:
    """Multi-process SLAM driver: the bootstrap runs host-locally
    (identical on every rank: the step is deterministic), then the state
    is cut to the mesh and the steady frames run the sharded step.  The
    map keeps the bootstrap's capacity: there are no capacity tiers (no
    repack between ranks), so `n_map` must divide it."""

    def __init__(self, config: SFConfig, n_pix: int, n_map: int,
                 mesh: mesh_lib.Mesh | None = None, device="cuda",
                 runtime: Runtime | None = None):
        from staticfusion_tpu_torch.parallel.sharded import make_sharded_step

        entry_device(device)  # raises without the card unless "cpu"
        if mesh is None:
            if runtime is None:
                raise ValueError("pass a mesh, or the runtime of "
                                 "initialize() to build one")
            mesh = global_mesh(n_pix, n_map, runtime)
        if (mesh.n_pix, mesh.n_map) != (n_pix, n_map):
            raise ValueError(f"mesh is {mesh.n_pix}x{mesh.n_map}, not "
                             f"{n_pix}x{n_map}")
        self.device = mesh.device
        self.config = config
        self.mesh = mesh
        self.step = make_sharded_step(config, mesh)
        self.state = None
        self._pending = None
        self.poses = []
        self.outputs = None

    def process(self, rgb: np.ndarray, depth_mm: np.ndarray):
        from staticfusion_tpu_torch.pipeline.step import Frame, bootstrap_step

        frame_host = Frame(rgb=np.asarray(rgb, np.float32),
                           depth_mm=np.asarray(depth_mm, np.float32))
        if self.state is None and self._pending is None:
            self._pending = frame_host
            return None
        if self.state is None:
            to_dev = lambda f: Frame(*[torch.as_tensor(a, device=self.device)
                                       for a in f])
            state, out = bootstrap_step(to_dev(self._pending),
                                        to_dev(frame_host),
                                        torch.eye(4, device=self.device),
                                        self.config)
            self.state = put_state(state, self.mesh)
        else:
            self.state, out = self.step(self.state,
                                        put_frame(frame_host, self.mesh))
        self.outputs = out
        pose = fetch_replicated(out.curr_pose)
        self.poses.append(pose)
        return pose
