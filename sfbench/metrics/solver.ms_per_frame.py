"""Milliseconds a frame in `pipeline.step.run_solver` (span `solver`,
synchronised at both ends), over the traced run's span frames."""


def read(trace):
    rec = trace.spans.get("solver") or []
    if not rec or trace.frames_timed <= 0:
        return None
    return 1e3 * sum(s for s, _ in rec) / trace.frames_timed
