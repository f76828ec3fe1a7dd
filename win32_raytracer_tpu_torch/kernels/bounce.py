"""Kernel B: one fused bounce of the persistent scheduler (``csrc/bounce.cu``).

Replaces ``win32_raytracer_tpu/kernels/bounce_pallas.py`` (``_bounce_kernel``
via ``p_bounce_fused``), with the pieces it inlines:
``hit_pallas_v7.hit_sky_values`` and ``scatter_pallas.kernel_draws`` /
``scatter_respawn_values`` / ``pack_camera``.  Bound by the sphere sweep
of the live lanes; each lane's state is read once and written once and the
hit record stays in registers (csrc/bounce.cu has the detail).

:func:`bounce` launches the kernel for CUDA tensors and runs the plain
version, :func:`bounce_plain` (``persistent.p_bounce_step`` with the plain
sphere sweep), for tensors on the CPU; it raises for anything else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.hit import ATTR_COLS, SphereTable
from ..persistent import Dims, PathState, p_bounce_step
from ..scene.camera import Camera
from . import _build
from .hit import hit_spheres_rows_plain

LAUNCHES = 0  # kernel launches by bounce

# Packed camera layout (csrc/common.cuh CamRow).
_C_ORIGIN, _C_LLC, _C_HORIZ, _C_VERT, _C_RIGHT, _C_UP = 0, 3, 6, 9, 12, 15
_C_LENS, _C_SH_OPEN, _C_SH_CLOSE = 18, 19, 20
CAM_ROWS = 21


def pack_camera(cam: Camera) -> torch.Tensor:
    """Camera -> [CAM_ROWS] f32 on the camera's device."""
    return torch.cat([torch.as_tensor(getattr(cam, f)).to(torch.float32)
                      .reshape(-1) for f in Camera._fields]).contiguous()


def unpack_camera(cam_rows: torch.Tensor) -> Camera:
    """Inverse of :func:`pack_camera` (views into ``cam_rows``)."""
    c = cam_rows
    return Camera(origin=c[_C_ORIGIN:_C_ORIGIN + 3],
                  lower_left_corner=c[_C_LLC:_C_LLC + 3],
                  horizontal=c[_C_HORIZ:_C_HORIZ + 3],
                  vertical=c[_C_VERT:_C_VERT + 3],
                  right_axis=c[_C_RIGHT:_C_RIGHT + 3],
                  up_axis=c[_C_UP:_C_UP + 3],
                  lens_radius=c[_C_LENS], shutter_open=c[_C_SH_OPEN],
                  shutter_close=c[_C_SH_CLOSE])


def bounce_plain(table: SphereTable, cam_rows: torch.Tensor, st: PathState,
                 salt, step, dims: Dims, *, cfg: RenderConfig,
                 lean: bool = False) -> PathState:
    """The plain bounce: hit + sky, scatter, respawn in torch ops."""
    return p_bounce_step(table, unpack_camera(cam_rows), st, salt, step,
                         dims, cfg=cfg, hit_fn=hit_spheres_rows_plain,
                         lean=lean)


class StepParams(ctypes.Structure):  # csrc/common.cuh StepParams
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("kpp", ctypes.c_int32), ("kx", ctypes.c_int32),
        ("ky", ctypes.c_int32), ("max_depth", ctypes.c_int32),
        ("rr_start", ctypes.c_int32), ("eps", ctypes.c_float),
        ("reflect_thres", ctypes.c_float), ("refract_bias", ctypes.c_float),
        ("schlick_ni", ctypes.c_int32),
    ]


_STATE_IN = ("origin", "direction", "time", "throughput", "radiance_sum",
             "depth", "sample", "pixel", "path_alive", "s_base", "s_quota")


class BounceArgs(ctypes.Structure):  # csrc/bounce.cu BounceArgs
    _fields_ = ([(f, ctypes.c_void_p) for f in _STATE_IN]
                + [("attrs", ctypes.c_void_p), ("active", ctypes.c_void_p),
                   ("cam", ctypes.c_void_p), ("out_f", ctypes.c_void_p),
                   ("out_i", ctypes.c_void_p), ("out_alive", ctypes.c_void_p),
                   ("n", ctypes.c_longlong), ("n_spheres", ctypes.c_int),
                   ("salt", ctypes.c_uint32), ("step", ctypes.c_int32),
                   ("min_t", ctypes.c_float), ("p", StepParams),
                   ("stream", ctypes.c_void_p)])


def bounce(table: SphereTable, cam_rows: torch.Tensor, st: PathState, salt,
           step, dims: Dims, *, cfg: RenderConfig,
           lean: bool = False) -> PathState:
    """One bounce (hit + sky + scatter + respawn) of every lane of ``st``;
    ``salt`` / ``step`` key the draws as in ``persistent._scatter_core``."""
    global LAUNCHES
    dev = st.origin.device
    if dev.type == "cpu":
        return bounce_plain(table, cam_rows, st, salt, step, dims, cfg=cfg,
                            lean=lean)
    if dev.type != "cuda":
        raise ValueError(f"bounce: unsupported device {dev}")
    n = st.origin.shape[1]
    s = table.attrs.shape[0]
    f32, i32 = torch.float32, torch.int32
    for f, dt, rows in zip(_STATE_IN, (f32,) * 5 + (i32,) * 3
                           + (torch.bool, i32, i32),
                           (3, 3, 1, 3, 3, 1, 1, 1, 1, 1, 1)):
        _build.check_tensor(getattr(st, f), f, dt, (rows, n), dev)
    _build.check_tensor(table.attrs, "attrs", f32, (s, ATTR_COLS), dev)
    _build.check_tensor(table.active, "active", torch.bool, (s,), dev)
    _build.check_tensor(cam_rows, "cam_rows", f32, (CAM_ROWS,), dev)

    out_f = torch.empty((13, n), dtype=f32, device=dev)
    out_i = torch.empty((2, n), dtype=i32, device=dev)
    alive = torch.empty((1, n), dtype=torch.bool, device=dev)
    if n:
        lib = _build.load()
        params = StepParams(
            dims.width, dims.height, dims.kpp, dims.kx, dims.ky,
            dims.max_depth, dims.rr_start, float(np.float32(cfg.epsilon)),
            float(np.float32(cfg.reflect_thres)),
            float(np.float32(cfg.refract_discriminant_bias)),
            int(bool(cfg.schlick_uses_ni_over_nt)))
        args = BounceArgs(
            *(getattr(st, f).data_ptr() for f in _STATE_IN),
            table.attrs.data_ptr(), table.active.data_ptr(),
            cam_rows.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            alive.data_ptr(), n, s, int(salt) & 0xFFFFFFFF,
            int(np.int32(step)), float(cfg.min_hit_t), params,
            _build.stream_handle(dev))
        _build.check(lib.wrt_bounce(ctypes.addressof(args), int(lean)),
                     "bounce")
        LAUNCHES += 1
    return st._replace(origin=out_f[0:3], direction=out_f[3:6],
                       time=out_f[6:7], throughput=out_f[7:10],
                       radiance_sum=out_f[10:13], depth=out_i[0:1],
                       sample=out_i[1:2], path_alive=alive)
