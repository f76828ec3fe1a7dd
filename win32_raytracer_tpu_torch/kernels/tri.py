"""Kernel C: the brute triangle sweep in rows layout (``csrc/tri.cu``).

Replaces ``win32_raytracer_tpu/kernels/tri_pallas_mxu.py``
(``_tri_kernel_mxu``), the triangle pass of meshes below the grid
threshold and of every mesh under ``accel="off"``.  Bound by instruction
issue in the T pair tests per ray: each block stages the active triangles
packed with their original rows, a first pass over 8 of them keeps the
pairs that may hit with no division, a second runs the exact test on
those; each thread sweeps two rays where the batch still gives every SM a
block, one where it does not (``kernels/hit.rays_per_thread``, as kernel
A; the source note in csrc/tri.cu has the detail).

:func:`hit_triangles_rows` launches the kernel for CUDA tensors and runs the
plain version, :func:`hit_triangles_rows_plain` (ops/hit_tri.py), for
tensors on the CPU; it raises for anything else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ..config import MIN_HIT_T
from ..ops.hit_tri import TRI_ATTR_COLS, TriTable, tri_table
from ..ops.hit_tri import hit_triangles_rows as hit_triangles_rows_plain
from ..ops.rows import HitRecordRows
from ..scene.triangles import TriangleScene
from . import _build
from .hit import check_rays, launch_rays, record_buffers, record_rows

LAUNCHES = 0  # kernel launches by hit_triangles_rows


class TriArgs(ctypes.Structure):  # csrc/common.cuh TriArgs (kernels C and H)
    _fields_ = [
        ("origin", ctypes.c_void_p), ("direction", ctypes.c_void_p),
        ("attrs", ctypes.c_void_p), ("active", ctypes.c_void_p),
        ("out_f", ctypes.c_void_p), ("out_i", ctypes.c_void_p),
        ("out_hit", ctypes.c_void_p), ("n", ctypes.c_longlong),
        ("n_tris", ctypes.c_int), ("min_t", ctypes.c_float),
        ("stream", ctypes.c_void_p),
    ]


def hit_triangles_rows(scene: Union[TriangleScene, TriTable],
                       origin: torch.Tensor, direction: torch.Tensor,
                       time: torch.Tensor, min_t: float = MIN_HIT_T, *,
                       _rays: Optional[int] = None) -> HitRecordRows:
    """Nearest two-sided triangle hit of rays o/d [3, N] (``time`` [1, N]
    is unused: meshes are static).

    ``_rays`` (1 or 2; default ``kernels/hit.rays_per_thread``) forces the
    launch form on a card, for checks; the record is the same whatever it
    is."""
    global LAUNCHES
    check_rays("hit_triangles_rows", _rays)
    dev = origin.device
    if dev.type == "cpu":
        return hit_triangles_rows_plain(scene, origin, direction, time,
                                        min_t=min_t)
    if dev.type != "cuda":
        raise ValueError(f"hit_triangles_rows: unsupported device {dev}")
    tab = tri_table(scene)
    n = origin.shape[1]
    s = tab.attrs.shape[0]
    for t, name, dt, shape in (
            (origin, "origin", torch.float32, (3, n)),
            (direction, "direction", torch.float32, (3, n)),
            (tab.attrs, "attrs", torch.float32, (s, TRI_ATTR_COLS)),
            (tab.active, "active", torch.bool, (s,))):
        _build.check_tensor(t, name, dt, shape, dev)

    rays = launch_rays(n, dev, _rays)

    out_f, out_i, hit = record_buffers(n, dev)
    if n:
        lib = _build.load()
        args = TriArgs(
            origin.data_ptr(), direction.data_ptr(), tab.attrs.data_ptr(),
            tab.active.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            hit.data_ptr(), n, s, float(min_t), _build.stream_handle(dev))
        _build.check(lib.wrt_hit_triangles(ctypes.addressof(args), rays),
                     "hit_triangles_rows")
        LAUNCHES += 1
    return record_rows(out_f, out_i, hit)
