"""The yardstick of kernel C's roofline share (the brute triangle sweep):
the operations and bytes that the inputs need, against ``roofline.py``'s
peaks.

As the sphere sweep's, the work is counted from the inputs, not from the
port's launches: primary rays x the cell's mean segments per primary ray
(``segments.py``, stored in the cell file) x the active triangles x the
operations of one pair test.  So it reads the same whatever implements
the sweep; a later program that skips triangles (a grid or a BVH below
the threshold) makes this count stale, and a ``benchmark`` change
corrects it.
"""

from __future__ import annotations

from port_bench import roofline, spans

# Kernel C reads a ray's origin and direction (its time is unused: meshes
# are static) and writes a hit record (12 f32, 2 int32, one bool).
SEGMENT_BYTES = 6 * 4 + 12 * 4 + 2 * 4 + 1
ROW_BYTES = 16 * 4 + 1   # a triangle's packed attributes and its active flag


def tri_brute_bound_s(primary_rays: float, segments_per_primary: float,
                      triangles: dict) -> float:
    """Bound seconds of the brute triangle sweeps of ``primary_rays``
    rays: every segment against every active triangle of a scene's
    triangle arrays."""
    segs = primary_rays * segments_per_primary
    active = int(triangles["active"].sum())
    table = int(triangles["active"].shape[0]) * ROW_BYTES
    return roofline.bound_s(segs * active * spans.OPS_TRI_PAIR,
                            segs * SEGMENT_BYTES + table)
