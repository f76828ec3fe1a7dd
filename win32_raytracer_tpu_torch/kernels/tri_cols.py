"""Kernel H: the brute triangle sweep in column layout (``csrc/tri_cols.cu``).

Replaces ``win32_raytracer_tpu/kernels/tri_pallas.py`` (``_tri_kernel``,
reached through ``hit_triangles_pallas``), the wavefront scheduler's
triangle sweep.  Kernel C's sweep with the [N, 3] ray load and a column
record: the active triangles staged packed, a division-free mask pass per
8 of them, then the exact test on the pairs it keeps; two rays per thread
where the batch still gives every SM a block, else one (the source note in
csrc/tri_cols.cu has the detail).

:func:`hit_triangles_cols` launches the kernel for CUDA tensors and runs
the plain version, ``ops/hit_tri.hit_triangles``, for tensors on the CPU;
it raises for anything else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ..config import MIN_HIT_T
from ..ops.hit import HitRecord
from ..ops.hit_tri import TRI_ATTR_COLS, TriTable, hit_triangles, tri_table
from ..scene.triangles import TriangleScene
from . import _build
from .hit import check_rays, launch_rays
from .hit_cols import record_buffers_cols, record_cols
from .tri import TriArgs

LAUNCHES = 0  # kernel launches by hit_triangles_cols


def hit_triangles_cols(scene: Union[TriangleScene, TriTable],
                       origin: torch.Tensor, direction: torch.Tensor,
                       time: torch.Tensor, min_t: float = MIN_HIT_T, *,
                       _rays: Optional[int] = None) -> HitRecord:
    """Nearest two-sided triangle hit of rays o/d [N, 3] (``time`` [N] is
    unused: meshes are static).  ``_rays`` forces the launch form on a
    card, as for :func:`kernels.tri.hit_triangles_rows`."""
    global LAUNCHES
    check_rays("hit_triangles_cols", _rays)
    dev = origin.device
    if dev.type == "cpu":
        return hit_triangles(scene, origin, direction, time, min_t=min_t)
    if dev.type != "cuda":
        raise ValueError(f"hit_triangles_cols: unsupported device {dev}")
    tab = tri_table(scene)
    n = origin.shape[0]
    s = tab.attrs.shape[0]
    for t, name, dt, shape in (
            (origin, "origin", torch.float32, (n, 3)),
            (direction, "direction", torch.float32, (n, 3)),
            (tab.attrs, "attrs", torch.float32, (s, TRI_ATTR_COLS)),
            (tab.active, "active", torch.bool, (s,))):
        _build.check_tensor(t, name, dt, shape, dev)

    rays = launch_rays(n, dev, _rays)

    out_f, out_i, hit = record_buffers_cols(n, dev)
    if n:
        lib = _build.load()
        args = TriArgs(
            origin.data_ptr(), direction.data_ptr(), tab.attrs.data_ptr(),
            tab.active.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            hit.data_ptr(), n, s, float(min_t), _build.stream_handle(dev))
        _build.check(lib.wrt_hit_triangles_cols(ctypes.addressof(args), rays),
                     "hit_triangles_cols")
        LAUNCHES += 1
    return record_cols(out_f, out_i, hit)
