"""Kernel E: the hit + sky half of the split bounce (``csrc/hit_sky.cu``).

Replaces ``win32_raytracer_tpu/kernels/hit_pallas_v7.py``
(``_hit_sky_kernel`` via ``p_hit_sky_step``): the sphere sweep, the
winner's record and the miss-to-sky radiance and alive update in one
launch.  The persistent scheduler runs it above the compaction floor
whenever it does not fuse the whole bounce (``fuse_bounce="off"``, an
explicit ``scatter_backend``, pixel ids of 2^24 and up), followed by the
scatter and respawn.  Bound by the sphere sweep: kernel A's packed sweep,
two lanes a thread on a batch that fills the card, else one
(``kernels/hit.rays_per_thread``).

:func:`hit_sky` launches the kernel for CUDA tensors and runs the plain
version, :func:`hit_sky_plain` (``persistent.p_hit_step`` with the plain
sphere sweep), for tensors on the CPU; it raises for anything else.  Both
return ``(record, state)`` with the state's radiance and alive rows
updated.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..config import RenderConfig
from ..ops.hit import ATTR_COLS, SphereTable
from ..ops.rows import HitRecordRows
from ..persistent import PathState, p_hit_step
from . import _build
from .hit import (check_rays, hit_spheres_rows_plain, launch_rays,
                  record_buffers, record_rows)

LAUNCHES = 0  # kernel launches by hit_sky


def hit_sky_plain(table: SphereTable, st: PathState, *, cfg: RenderConfig):
    """The plain hit + sky step."""
    return p_hit_step(table, st, cfg=cfg, hit_fn=hit_spheres_rows_plain)


class HitSkyArgs(ctypes.Structure):  # csrc/hit_sky.cu HitSkyArgs
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "origin", "direction", "time", "throughput", "radiance", "alive",
        "attrs", "active", "out_f", "out_i", "out_hit", "out_rad",
        "out_alive")] + [
        ("n", ctypes.c_longlong), ("n_spheres", ctypes.c_int),
        ("min_t", ctypes.c_float), ("stream", ctypes.c_void_p)]


def hit_sky(table: SphereTable, st: PathState, *, cfg: RenderConfig,
            _rays: Optional[int] = None) -> tuple[HitRecordRows, PathState]:
    """Nearest sphere hit of every lane's ray, then the sky for the live
    lanes that miss (radiance += throughput * sky, alive &= hit).

    ``_rays`` (1 or 2 lanes per thread; default
    :func:`~.hit.rays_per_thread`) forces the launch form on a card, for
    checks; the result is the same whatever it is."""
    global LAUNCHES
    check_rays("hit_sky", _rays)
    dev = st.origin.device
    if dev.type == "cpu":
        return hit_sky_plain(table, st, cfg=cfg)
    if dev.type != "cuda":
        raise ValueError(f"hit_sky: unsupported device {dev}")
    n = st.origin.shape[1]
    s = table.attrs.shape[0]
    f32 = torch.float32
    for t, name, dt, shape in (
            (st.origin, "origin", f32, (3, n)),
            (st.direction, "direction", f32, (3, n)),
            (st.time, "time", f32, (1, n)),
            (st.throughput, "throughput", f32, (3, n)),
            (st.radiance_sum, "radiance_sum", f32, (3, n)),
            (st.path_alive, "path_alive", torch.bool, (1, n)),
            (table.attrs, "attrs", f32, (s, ATTR_COLS)),
            (table.active, "active", torch.bool, (s,))):
        _build.check_tensor(t, name, dt, shape, dev)

    out_f, out_i, hit = record_buffers(n, dev)
    rad = torch.empty((3, n), dtype=f32, device=dev)
    alive = torch.empty((1, n), dtype=torch.bool, device=dev)
    if n:
        lib = _build.load()
        args = HitSkyArgs(
            st.origin.data_ptr(), st.direction.data_ptr(), st.time.data_ptr(),
            st.throughput.data_ptr(), st.radiance_sum.data_ptr(),
            st.path_alive.data_ptr(), table.attrs.data_ptr(),
            table.active.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            hit.data_ptr(), rad.data_ptr(), alive.data_ptr(), n, s,
            float(cfg.min_hit_t), _build.stream_handle(dev))
        _build.check(lib.wrt_hit_sky(ctypes.addressof(args),
                                     launch_rays(n, dev, _rays)), "hit_sky")
        LAUNCHES += 1
    return (record_rows(out_f, out_i, hit),
            st._replace(radiance_sum=rad, path_alive=alive))
