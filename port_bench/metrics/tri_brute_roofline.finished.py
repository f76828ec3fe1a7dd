"""Kernel C's share (%) of its roofline: the least time of the brute
triangle sweeps the traced calls need (``roofline_tri.py``: primary rays
x segments per primary x active triangles x 52 operations, counted from
the inputs), over kernel C's device time.  None where the trace, kernel
C's time or ``segments_per_primary`` is missing."""

from port_bench.metric_lib import device_ms
from port_bench.roofline_tri import tri_brute_bound_s

TRI_BRUTE = ("kernel C (triangle brute)",)


def read(s):
    t = s["trace"]
    seg = s["cell"].get("segments_per_primary")
    if not t or not seg or not seg.get("mean"):
        return None
    ms = device_ms(t, TRI_BRUTE)
    if ms <= 0:
        return None
    bound = tri_brute_bound_s(s["rays_per_call"] * t["calls"], seg["mean"],
                              s["arrays"]["triangles"])
    return 100.0 * bound / (ms / 1e3)
