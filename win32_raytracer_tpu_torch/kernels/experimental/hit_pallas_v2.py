"""``hit_spheres_pallas_v2`` on kernel G.

Replaces ``win32_raytracer_tpu/kernels/experimental/hit_pallas_v2.py``
(``_hit_kernel_v2`` :102, through ``hit_spheres_pallas_v2`` :182): the same
brute nearest hit as v1 with the quadratic factored into two small matrix
products.  It computes kernel G's function (``kernels/hit_cols.py``), which
evaluates the quadratic unfactored in exact f32, so it is held to the exact
sweep and not to the factoring's rounding.  ``ray_block`` is accepted and
ignored.
"""

from __future__ import annotations

from ...config import MIN_HIT_T
from ...ops.hit import HitRecord
from .hit_pallas_v1 import hit_spheres_pallas


def hit_spheres_pallas_v2(scene, origin, direction, time,
                          min_t: float = MIN_HIT_T,
                          ray_block: int = 1024) -> HitRecord:
    """Nearest hit of rays o/d [N, 3], time [N] (the ops/hit signature)."""
    return hit_spheres_pallas(scene, origin, direction, time, min_t=min_t,
                              ray_block=ray_block)
