"""Device kernels a frame in the profiled sub-window; memcpy and memset
are counted apart and left out."""


def read(trace):
    if trace.frames_profiled <= 0 or trace.kernels <= 0:
        return None
    return trace.kernels / trace.frames_profiled
