"""Mean milliseconds of a tier check (`SlamSystem._maybe_resize_map`,
span `tier_check`) that repacked or archived the map, i.e. replaced the
session's state; checks that only counted are left out."""


def read(trace):
    rec = [s for s, replaced in trace.spans.get("tier_check") or []
           if replaced]
    if not rec:
        return None
    return 1e3 * sum(rec) / len(rec)
