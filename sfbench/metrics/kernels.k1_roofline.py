"""K1's least time (sfbench.roofline's frozen tap and expf count of each
frame it preprocessed) over its device time, in the profiled
sub-window.  Nothing to read when the launches recorded and the kernels
traced do not pair up one to one."""

from sfbench import roofline

KERNEL = "preprocess_kernel"


def read(trace):
    launches = trace.probes.get("k1_launch") or []
    names = [k for k in trace.device_time if KERNEL in k]
    traced = sum(trace.device_count[k] for k in names)
    device_s = sum(trace.device_time[k] for k in names)
    if not launches or traced != len(launches) or device_s <= 0:
        return None
    least = sum(roofline.k1_seconds(r["rows"], r["cols"]) for r in launches)
    return 100.0 * least / device_s
