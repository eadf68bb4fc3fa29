"""The 95th percentile of a frame's time, from its hand-off to
`SlamSystem.process` until its pose is on the host, over the frames of a
traced run's window (nothing instrumented inside it; at least
MIN_FRAMES, so that ten or more lie beyond the percentile).  A per-layer
metric, not an end-to-end one: one session's tail spreads too widely
from run to run on the host's clock for a bound within 25%."""

import numpy as np

MIN_FRAMES = 200


def read(trace):
    if len(trace.frame_seconds) < MIN_FRAMES:
        return None
    return 1e3 * float(np.percentile(trace.frame_seconds, 95))
