"""Device-to-host scalar reads a frame (aten::_local_scalar_dense, what
`.item()`, `int()`, `float()` and `bool()` of a device tensor run) in the
profiled sub-window.  The benchmark's own pose read is a copy, not one of
these."""


def read(trace):
    if trace.frames_profiled <= 0:
        return None
    reads = trace.cpu_ops.get("aten::_local_scalar_dense", 0)
    return reads / trace.frames_profiled
