"""``hit_spheres_pallas`` on kernel G.

Replaces ``win32_raytracer_tpu/kernels/experimental/hit_pallas_v1.py``
(``_hit_kernel`` :55, through ``hit_spheres_pallas`` :146): the brute
nearest front-face sphere hit of column rays, the function of kernel G
(``kernels/hit_cols.py``), which computes it in exact f32.  The TPU kernel
gates spheres by r != 0 and returns sphere 0's attributes on a miss;
kernel G gates by the active mask (the scene's padding rows are exactly its
r = 0 rows) and writes zeros.  ``ray_block`` is accepted and ignored.
"""

from __future__ import annotations

from ...config import MIN_HIT_T
from ...ops.hit import HitRecord
from ..hit_cols import hit_spheres_cols

DEFAULT_RAY_BLOCK = 512


def hit_spheres_pallas(scene, origin, direction, time,
                       min_t: float = MIN_HIT_T,
                       ray_block: int = DEFAULT_RAY_BLOCK) -> HitRecord:
    """Nearest hit of rays o/d [N, 3], time [N] (the ops/hit signature)."""
    del ray_block
    return hit_spheres_cols(scene, origin.contiguous(),
                            direction.contiguous(), time.contiguous(),
                            min_t=min_t)
