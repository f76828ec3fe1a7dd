"""``hit_spheres_grid_pallas`` on kernel I's column instance.

Replaces ``win32_raytracer_tpu/kernels/experimental/hit_grid.py``
(``_grid_kernel`` :50, through ``hit_spheres_grid_pallas`` :160), the first
sphere grid: pass A over the globals (the reference's v3 kernel; here
kernel I's schedule kernel), the footprint mask, pass B over the scheduled
tiles and the (t, index) merge, on column rays.  ``kernels/hit_grid.hit_spheres_grid_cols``
computes it (kernel I, ``csrc/hit_grid.cu``); ``ray_block`` sets the
schedule's blocks, as in the reference.
"""

from __future__ import annotations

from ...accel import DEFAULT_RAY_BLOCK_GRID, GridScene
from ...config import MIN_HIT_T
from ...ops.hit import HitRecord
from ..hit_grid import hit_spheres_grid_cols


def hit_spheres_grid_pallas(gscene: GridScene, origin, direction, time,
                            min_t: float = MIN_HIT_T,
                            ray_block: int = DEFAULT_RAY_BLOCK_GRID
                            ) -> HitRecord:
    """Nearest hit of rays o/d [N, 3], time [N] through the sphere grid."""
    return hit_spheres_grid_cols(gscene, origin.contiguous(),
                                 direction.contiguous(), time.contiguous(),
                                 min_t=min_t, ray_block=ray_block)
