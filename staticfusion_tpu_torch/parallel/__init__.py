"""Pose-graph optimisation (staticfusion_tpu/parallel's posegraph on one
device; the mesh, sharded and multi-process modules are not ported)."""
