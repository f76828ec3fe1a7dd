"""Kernel A: the sphere hit sweep in rows layout (``csrc/hit.cu``).

Replaces ``win32_raytracer_tpu/kernels/hit_pallas_v6.py`` (``_hit_kernel_v6``),
the persistent scheduler's below-floor hit.  Bound by instruction issue in
the S pair tests per ray: each block stages the active spheres packed for
wide shared loads, and each thread sweeps two rays where the batch still
gives every SM a block, one ray where it does not
(:func:`rays_per_thread`; the source note in csrc/hit.cu has the detail).

:func:`hit_spheres_rows` launches the kernel for CUDA tensors and runs the
plain version, :func:`hit_spheres_rows_plain` (ops/hit.py), for tensors on
the CPU; it raises for anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from ..config import MIN_HIT_T
from ..ops.hit import ATTR_COLS, SphereTable, hit_spheres, sphere_table
from ..ops.rows import HitRecordRows, hit_rows_adapter
from ..scene.spheres import SphereScene
from . import _build

LAUNCHES = 0  # launches of hit_kernel by hit_spheres_rows

_BLOCK = 256  # csrc/common.cuh kBlock

hit_spheres_rows_plain = hit_rows_adapter(hit_spheres)


class HitArgs(ctypes.Structure):  # csrc/common.cuh HitArgs (kernels A and G)
    _fields_ = [
        ("origin", ctypes.c_void_p), ("direction", ctypes.c_void_p),
        ("time", ctypes.c_void_p), ("attrs", ctypes.c_void_p),
        ("active", ctypes.c_void_p), ("out_f", ctypes.c_void_p),
        ("out_i", ctypes.c_void_p), ("out_hit", ctypes.c_void_p),
        ("n", ctypes.c_longlong), ("n_spheres", ctypes.c_int),
        ("min_t", ctypes.c_float), ("stream", ctypes.c_void_p),
    ]


def record_rows(out_f: torch.Tensor, out_i: torch.Tensor,
                hit: torch.Tensor) -> HitRecordRows:
    """The HitRecordRows views of a hit kernel's outputs (out_f [12, N],
    out_i [2, N], hit [1, N]; csrc/common.cuh write_record)."""
    return HitRecordRows(
        hit=hit, t=out_f[0:1], point=out_f[1:4], normal=out_f[4:7],
        idx=out_i[0:1], mat_id=out_i[1:2], albedo=out_f[7:10],
        fuzz=out_f[10:11], ior=out_f[11:12])


def record_buffers(n: int, dev):
    """Empty (out_f, out_i, hit) for a hit kernel's record of n rays."""
    return (torch.empty((12, n), dtype=torch.float32, device=dev),
            torch.empty((2, n), dtype=torch.int32, device=dev),
            torch.empty((1, n), dtype=torch.bool, device=dev))


def rays_per_thread(n: int, n_sms: int) -> int:
    """Rays each thread of kernel A sweeps for a batch of ``n`` on a card of
    ``n_sms`` SMs: two while blocks of 2 x 256 rays give every SM one, else
    one, so that a small batch spreads over twice as many SMs."""
    return 2 if -(-n // (2 * _BLOCK)) >= n_sms else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_rays(who: str, rays: Optional[int]) -> None:
    """A forced launch form of a packed-sweep kernel (A, C, E, G, H) is 1
    or 2 rays per thread, on every device."""
    if rays not in (None, 1, 2):
        raise ValueError(f"{who}: _rays must be 1 or 2, not {rays}")


def launch_rays(n: int, dev: torch.device, rays: Optional[int]) -> int:
    """The launch form for ``n`` rays on card ``dev``: ``rays`` where
    given, else :func:`rays_per_thread`."""
    return rays or rays_per_thread(n, _sm_count(dev.index or 0))


def hit_spheres_rows(scene: Union[SphereScene, SphereTable],
                     origin: torch.Tensor, direction: torch.Tensor,
                     time: torch.Tensor, min_t: float = MIN_HIT_T, *,
                     _rays: Optional[int] = None) -> HitRecordRows:
    """Nearest front-face hit of rays o/d [3, N], t [1, N] f32.

    ``_rays`` (1 or 2; default :func:`rays_per_thread`) forces the launch
    form on a card, for checks; the record is the same whatever it is."""
    global LAUNCHES
    check_rays("hit_spheres_rows", _rays)
    dev = origin.device
    if dev.type == "cpu":
        return hit_spheres_rows_plain(scene, origin, direction, time,
                                      min_t=min_t)
    if dev.type != "cuda":
        raise ValueError(f"hit_spheres_rows: unsupported device {dev}")
    tab = sphere_table(scene)
    n = origin.shape[1]
    s = tab.attrs.shape[0]
    for t, name, dt, shape in (
            (origin, "origin", torch.float32, (3, n)),
            (direction, "direction", torch.float32, (3, n)),
            (time, "time", torch.float32, (1, n)),
            (tab.attrs, "attrs", torch.float32, (s, ATTR_COLS)),
            (tab.active, "active", torch.bool, (s,))):
        _build.check_tensor(t, name, dt, shape, dev)

    rays = launch_rays(n, dev, _rays)

    out_f, out_i, hit = record_buffers(n, dev)
    if n:
        lib = _build.load()
        args = HitArgs(
            origin.data_ptr(), direction.data_ptr(), time.data_ptr(),
            tab.attrs.data_ptr(), tab.active.data_ptr(), out_f.data_ptr(),
            out_i.data_ptr(), hit.data_ptr(), n, s, float(min_t),
            _build.stream_handle(dev))
        _build.check(lib.wrt_hit_spheres(ctypes.addressof(args), rays),
                     "hit_spheres_rows")
        LAUNCHES += 1
    return record_rows(out_f, out_i, hit)
