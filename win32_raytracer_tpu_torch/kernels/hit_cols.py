"""Kernel G: the sphere hit sweep in column layout (``csrc/hit_cols.cu``).

Replaces ``win32_raytracer_tpu/kernels/hit_pallas_v3.py``
(``_hit_kernel_v3``), the wavefront scheduler's sphere hit.  Kernel A's
body with the [N, 3] ray load and a column record: bound by the S pair
tests per ray; the packed sweep, two rays a thread on a batch that fills
the card, else one (``kernels/hit.rays_per_thread``; the source note in
csrc/hit_cols.cu has the detail).

:func:`hit_spheres_cols` launches the kernel for CUDA tensors and runs the
plain version, ``ops/hit.hit_spheres``, for tensors on the CPU; it raises
for anything else.  The kernel writes the record as out_f [N, 12] (t,
point, normal, albedo, fuzz, ior) and out_i [N, 2] (idx, mat_id) and the
hit flags [N]; the record's fields are views of those buffers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ..config import MIN_HIT_T
from ..ops.hit import ATTR_COLS, HitRecord, SphereTable, hit_spheres, sphere_table
from ..scene.spheres import SphereScene
from . import _build
from .hit import HitArgs, check_rays, launch_rays

LAUNCHES = 0  # kernel launches by hit_spheres_cols


def record_cols(out_f: torch.Tensor, out_i: torch.Tensor,
                hit: torch.Tensor) -> HitRecord:
    """The column HitRecord views of a column hit kernel's outputs (out_f
    [N, 12], out_i [N, 2], hit [N]; csrc/common.cuh store_record)."""
    return HitRecord(
        hit=hit, t=out_f[:, 0], point=out_f[:, 1:4], normal=out_f[:, 4:7],
        idx=out_i[:, 0], mat_id=out_i[:, 1], albedo=out_f[:, 7:10],
        fuzz=out_f[:, 10], ior=out_f[:, 11])


def record_buffers_cols(n: int, dev):
    """Empty (out_f, out_i, hit) for a column hit kernel's record."""
    return (torch.empty((n, 12), dtype=torch.float32, device=dev),
            torch.empty((n, 2), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.bool, device=dev))


def hit_spheres_cols(scene: Union[SphereScene, SphereTable],
                     origin: torch.Tensor, direction: torch.Tensor,
                     time: torch.Tensor, min_t: float = MIN_HIT_T, *,
                     _rays: Optional[int] = None) -> HitRecord:
    """Nearest front-face hit of rays o/d [N, 3], time [N] f32.

    ``_rays`` (1 or 2; default :func:`~.hit.rays_per_thread`) forces the
    launch form on a card, for checks; the record is the same whatever it
    is."""
    global LAUNCHES
    check_rays("hit_spheres_cols", _rays)
    dev = origin.device
    if dev.type == "cpu":
        return hit_spheres(scene, origin, direction, time, min_t=min_t)
    if dev.type != "cuda":
        raise ValueError(f"hit_spheres_cols: unsupported device {dev}")
    tab = sphere_table(scene)
    n = origin.shape[0]
    s = tab.attrs.shape[0]
    for t, name, dt, shape in (
            (origin, "origin", torch.float32, (n, 3)),
            (direction, "direction", torch.float32, (n, 3)),
            (time, "time", torch.float32, (n,)),
            (tab.attrs, "attrs", torch.float32, (s, ATTR_COLS)),
            (tab.active, "active", torch.bool, (s,))):
        _build.check_tensor(t, name, dt, shape, dev)

    out_f, out_i, hit = record_buffers_cols(n, dev)
    if n:
        lib = _build.load()
        args = HitArgs(
            origin.data_ptr(), direction.data_ptr(), time.data_ptr(),
            tab.attrs.data_ptr(), tab.active.data_ptr(), out_f.data_ptr(),
            out_i.data_ptr(), hit.data_ptr(), n, s, float(min_t),
            _build.stream_handle(dev))
        _build.check(lib.wrt_hit_spheres_cols(ctypes.addressof(args),
                                              launch_rays(n, dev, _rays)),
                     "hit_spheres_cols")
        LAUNCHES += 1
    return record_cols(out_f, out_i, hit)
