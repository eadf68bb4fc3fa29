"""The multi-device layer (port of staticfusion_tpu/parallel): the
(pix, map) mesh and its collectives (mesh), the sharded step (sharded),
the multi-process runtime (distributed) and the pose-graph solvers, dense,
chain and sharded (posegraph).  Import the submodules directly."""
