"""Lanes kernel C swept (the port's ``tri_brute.lanes``) per segment the
recorded calls need (primary rays x ``segments_per_primary``): above 1 by
the dead and padded lanes that compaction has not yet dropped.  None on a
program without the counter, or without the constant."""

from port_bench import spans


def read(s):
    log = spans.port_log()
    seg = s["cell"].get("segments_per_primary")
    if not log or not seg or not seg.get("mean"):
        return None
    lanes = spans.counter(log, "tri_brute.lanes")
    if lanes <= 0:
        return None
    return lanes / (s["rays_per_call"] * spans.calls(log) * seg["mean"])
