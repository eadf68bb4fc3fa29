"""Sharded (multi-rank) SLAM step (port of
staticfusion_tpu/parallel/sharded.py).

The JAX package compiles the step once with GSPMD shardings and lets XLA
place the collectives.  Here every rank runs the same step on its blocks
(`slam_step(..., mesh=mesh)`): image rows over `pix`, surfel slots over
`map`, with the collectives of parallel/mesh.py at the reduction
boundaries (the solver's gathered system, the z-buffer scatter-mins, the
winners' rows, the per-cluster sums).  K1 (the depth filter) and K3 (the
IRLS solve) run whole on every rank: a stencil over the frame and one
cooperative launch over the gathered system, with no point mid-launch
for a collective.  Numerically this is the single-process step
(tests/test_torch_parallel.py holds them together).
"""

from __future__ import annotations

from staticfusion_tpu_torch.config import SFConfig
from staticfusion_tpu_torch.parallel.mesh import Mesh
from staticfusion_tpu_torch.pipeline.step import bootstrap_step, slam_step


def make_sharded_step(config: SFConfig, mesh: Mesh):
    """(local state, local frame) -> (local state, StepOutputs whole on
    every rank), the blocks laid out as mesh.state_shardings and
    mesh.frame_shardings."""
    def step(state, frame):
        return slam_step(state, frame, config, mesh=mesh)
    return step


def make_sharded_bootstrap(config: SFConfig, mesh: Mesh):
    """(local frame 0, local frame 1, initial pose) -> (local state,
    StepOutputs): the frames arrive row-sharded and the state comes out
    in the steady-state layout, so a whole trajectory (bootstrap
    included) runs under one plan."""
    def boot(frame0, frame1, initial_pose):
        return bootstrap_step(frame0, frame1, initial_pose, config,
                              mesh=mesh)
    return boot
