"""The yardstick of the kernels' roofline shares: the H100's published
peaks and the operations and bytes that the inputs need (copies of
``chip_smoke.py``'s ``bound`` and ``sphere_ops``).

The sphere sweep's work is counted from the inputs, not from the port's
launches, so it reads the same whatever implements it: primary rays x the
cell's mean segments per primary ray (``segments.py``, stored in the cell
file) x the active spheres x the operations of one pair test.  A later
program that stops testing every sphere (a BVH) makes this count stale,
and a ``benchmark`` change corrects it.
"""

from __future__ import annotations

import numpy as np

PEAK_F32 = 67e12        # f32 FLOP/s outside the tensor cores (SXM, 700 W)
PEAK_BYTES = 3.35e12    # HBM3 bytes/s
OPS_SPHERE_PAIR = 24    # csrc/common.cuh: one packed sphere pair test
OPS_SPHERE_PAIR_LERP = 26   # where a stage's (t1, 1 / (t2 - t1)) differ
SEGMENT_BYTES = 7 * 4 + 8 * 4   # a ray in (origin, direction, time), a hit out
STAGE = 256             # spheres a sweep stages at once


def sphere_ops(spheres: dict) -> int:
    """f32 operations of one ray's pair tests against every active sphere
    of a scene's sphere arrays, stage by stage."""
    act = spheres["active"]
    t1 = spheres["t1"].astype(np.float32)
    invdt = (np.float32(1) / (spheres["t2"] - spheres["t1"])).astype(np.float32)
    key = np.stack([t1.view(np.uint32), invdt.view(np.uint32)], 1)
    ops = 0
    for base in range(0, len(act), STAGE):
        on = act[base:base + STAGE]
        rows = key[base:base + STAGE][on]
        shared = len(rows) == 0 or bool((rows == rows[0]).all())
        ops += int(on.sum()) * (OPS_SPHERE_PAIR if shared else OPS_SPHERE_PAIR_LERP)
    return ops


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operation
    bound and the byte bound, in seconds."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def sphere_sweep_bound_s(primary_rays: float, segments_per_primary: float,
                         spheres: dict) -> float:
    """Bound seconds of the sphere sweeps of ``primary_rays`` rays."""
    segs = primary_rays * segments_per_primary
    table = int(spheres["active"].shape[0]) * 16 * 4
    return bound_s(segs * sphere_ops(spheres), segs * SEGMENT_BYTES + table)
