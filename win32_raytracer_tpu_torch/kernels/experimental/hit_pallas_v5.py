"""``hit_spheres_pallas_v5`` on kernel A.

Replaces ``win32_raytracer_tpu/kernels/experimental/hit_pallas_v5.py``
(``_hit_kernel_v5`` :56, through ``hit_spheres_pallas_v5`` :137): the brute
nearest hit of rows rays with the quadratic's dot products as bf16 matrix
products (27% of its winners flip at default precision, by its own note).
It computes kernel A's function (``kernels/hit.py``), in exact f32, so it is
held to the exact sweep and not to those roundings.  ``ray_block`` is
accepted and ignored.
"""

from __future__ import annotations

from ...config import MIN_HIT_T
from ...ops.rows import HitRecordRows
from ..hit import hit_spheres_rows

DEFAULT_RAY_BLOCK_V5 = 2048


def hit_spheres_pallas_v5(scene, origin, direction, time,
                          min_t: float = MIN_HIT_T,
                          ray_block: int = DEFAULT_RAY_BLOCK_V5
                          ) -> HitRecordRows:
    """Nearest hit of rays o/d [3, N], time [1, N] (the rows signature)."""
    del ray_block
    return hit_spheres_rows(scene, origin.contiguous(),
                            direction.contiguous(), time.contiguous(),
                            min_t=min_t)
