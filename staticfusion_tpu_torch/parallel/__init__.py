"""Pose-graph optimisation (the parts of staticfusion_tpu/parallel that
loop closure reaches)."""
