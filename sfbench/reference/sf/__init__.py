"""A frozen copy of the port's per-frame step (`staticfusion_tpu_torch`
as the benchmark was defined), plain PyTorch only: the bilateral filter,
the IRLS loop and the small solves run their plain versions, never a CUDA
kernel, and no module imports the port.  The benchmark's reference steps
it from the program's own state and compares what the program produced
(sfbench/reference/compare.py)."""
