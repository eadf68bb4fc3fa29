"""Share of the profiled sub-window in which no operation ran on the
device (the union of kernel, memcpy and memset intervals)."""


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
