"""Kernel F: the scatter + respawn half of the split bounce
(``csrc/scatter.cu``).

Replaces ``win32_raytracer_tpu/kernels/scatter_pallas.py``
(``_scatter_respawn_kernel`` via ``scatter_respawn_pallas``): the material
scatter, the depth and roulette update and the camera respawn, with the
draws made in the kernel.  It reads the hit record only where a lane is
alive and leaves the radiance rows alone, so it runs after any hit step:
kernel E, kernel A, the sphere grid, or the composite of a triangle
scene.  The persistent scheduler runs it in every split bounce of a render
with no fused bounce, above and below the compaction floor, and above the
floor only under ``scatter_backend="pallas"``
(``persistent.resolve_routes``).  Bound by memory (csrc/scatter.cu).

:func:`scatter_respawn` launches the kernel for CUDA tensors and runs the
plain version, :func:`scatter_respawn_plain`
(``persistent.p_scatter_respawn_step``), for tensors on the CPU; it raises
for anything else.  The camera is packed as for kernel B
(``kernels/bounce.pack_camera`` or ``pack_cameras``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.rows import HitRecordRows
from ..persistent import Dims, PathState, p_scatter_respawn_step
from . import _build
from .bounce import (
    StateRows, StepParams, check_camera, state_rows, step_params, unpack_camera)

LAUNCHES = 0  # kernel launches by scatter_respawn


def scatter_respawn_plain(cam_rows: torch.Tensor, st: PathState,
                          rec: HitRecordRows, salt, step, dims: Dims, *,
                          cfg: RenderConfig, lean: bool = False) -> PathState:
    """The plain scatter + respawn step."""
    return p_scatter_respawn_step(unpack_camera(cam_rows), st, rec, salt,
                                  step, dims, cfg=cfg, lean=lean)


class ScatterArgs(ctypes.Structure):  # csrc/scatter.cu ScatterArgs
    _fields_ = ([("in_", StateRows)]
                + [(f, ctypes.c_void_p) for f in (
                    "point", "normal", "mat", "albedo", "fuzz", "ior", "cam",
                    "out_f", "out_i", "out_alive")]
                + [("n", ctypes.c_longlong), ("salt", ctypes.c_uint32),
                   ("step", ctypes.c_int32), ("p", StepParams),
                   ("stream", ctypes.c_void_p)])


_RECORD = (("point", torch.float32, 3), ("normal", torch.float32, 3),
           ("mat_id", torch.int32, 1), ("albedo", torch.float32, 3),
           ("fuzz", torch.float32, 1), ("ior", torch.float32, 1))


def scatter_respawn(cam_rows: torch.Tensor, st: PathState,
                    rec: HitRecordRows, salt, step, dims: Dims, *,
                    cfg: RenderConfig, lean: bool = False) -> PathState:
    """Scatter + respawn of every lane of ``st`` after a hit step (``st``'s
    alive rows already restricted to hits); ``salt`` / ``step`` key the
    draws as in ``persistent._scatter_core``."""
    global LAUNCHES
    dev = st.origin.device
    if dev.type == "cpu":
        return scatter_respawn_plain(cam_rows, st, rec, salt, step, dims,
                                     cfg=cfg, lean=lean)
    if dev.type != "cuda":
        raise ValueError(f"scatter_respawn: unsupported device {dev}")
    n = st.origin.shape[1]
    rows = state_rows(st, dev, with_radiance=False)
    # The record's rows as the kernel reads them, contiguous: a caller's
    # hit function may return views (ops/rows.hit_rows_adapter's
    # transposes of a column hit function's record).
    record = [getattr(rec, f).contiguous() for f, _, _ in _RECORD]
    for (f, dt, r), t in zip(_RECORD, record):
        _build.check_tensor(t, f, dt, (r, n), dev)
    n_frames = check_camera(cam_rows, dev)

    out_f = torch.empty((10, n), dtype=torch.float32, device=dev)
    out_i = torch.empty((2, n), dtype=torch.int32, device=dev)
    alive = torch.empty((1, n), dtype=torch.bool, device=dev)
    if n:
        lib = _build.load()
        args = ScatterArgs(
            rows, *(t.data_ptr() for t in record),
            cam_rows.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            alive.data_ptr(), n, int(salt) & 0xFFFFFFFF, int(np.int32(step)),
            step_params(dims, cfg, n_frames), _build.stream_handle(dev))
        _build.check(lib.wrt_scatter_respawn(ctypes.addressof(args),
                                             int(lean)), "scatter_respawn")
        LAUNCHES += 1
    return st._replace(origin=out_f[0:3], direction=out_f[3:6],
                       time=out_f[6:7], throughput=out_f[7:10],
                       depth=out_i[0:1], sample=out_i[1:2], path_alive=alive)
