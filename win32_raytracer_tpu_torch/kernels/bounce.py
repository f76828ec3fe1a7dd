"""Kernel B: one fused bounce of the persistent scheduler, and its k-bounce
variant (``csrc/bounce.cu``).

:func:`bounce` replaces ``win32_raytracer_tpu/kernels/bounce_pallas.py``
(``_bounce_kernel`` via ``p_bounce_fused``), with the pieces it inlines:
``hit_pallas_v7.hit_sky_values`` and ``scatter_pallas.kernel_draws`` /
``scatter_respawn_values`` / ``pack_camera``.  :func:`bounce_multi`
replaces ``p_bounce_multi_fused`` (k fused bounces per dispatch; with
:func:`bounce`, the single-card loop's tail below the floor unless
``multi_backend="xla"``): one launch runs k bounces with
each lane's state in registers.  Both are bound by the sphere sweep of the
live lanes; each lane's state is read once and written once per launch and
the hit record stays in registers (csrc/bounce.cu has the detail).

The camera operand is [CAM_ROWS] for one camera or [F, CAM_ROWS] for a
multi-frame batch (:func:`pack_cameras`); the kernels pick each lane's
camera from its pixel row.

``stats``, an int64 [2] tensor on the lanes' device or None, gains per
bounce the lanes whose path is alive when the bounce starts ([0]) and the
paths the roulette ends ([1]) (``persistent.BOUNCE_STATS``); the batch
loop passes one only while a render that stratifies or plays the roulette
records.  Without it the kernels are launched in their form that counts
nothing.

:func:`bounce` and :func:`bounce_multi` launch their kernels for CUDA
tensors and run their plain versions, :func:`bounce_plain` and
:func:`bounce_multi_plain` (``persistent.p_bounce_step`` and
``p_bounce_multi_step`` with the plain sphere sweep), for tensors on the
CPU; they raise for anything else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.hit import ATTR_COLS, SphereTable
from ..persistent import (
    _MULTI_K, Dims, PathState, p_bounce_multi_step, p_bounce_step)
from ..scene.camera import Camera
from . import _build
from .hit import hit_spheres_rows_plain

LAUNCHES = 0        # kernel launches by bounce
MULTI_LAUNCHES = 0  # kernel launches by bounce_multi

# Packed camera layout (csrc/common.cuh CamRow).
_C_ORIGIN, _C_LLC, _C_HORIZ, _C_VERT, _C_RIGHT, _C_UP = 0, 3, 6, 9, 12, 15
_C_LENS, _C_SH_OPEN, _C_SH_CLOSE = 18, 19, 20
CAM_ROWS = 21


def pack_camera(cam: Camera) -> torch.Tensor:
    """Camera -> [CAM_ROWS] f32 on the camera's device."""
    return torch.cat([torch.as_tensor(getattr(cam, f)).to(torch.float32)
                      .reshape(-1) for f in Camera._fields]).contiguous()


def pack_cameras(cams) -> torch.Tensor:
    """Cameras of a multi-frame batch -> [F, CAM_ROWS] f32, one row block
    per frame (the reference's [CAM_ROWS, F] matrix, transposed so that a
    frame's camera is contiguous)."""
    return torch.stack([pack_camera(c) for c in cams]).contiguous()


def unpack_camera(cam_rows: torch.Tensor) -> Camera:
    """Inverse of :func:`pack_camera` (views into ``cam_rows``); for
    [F, CAM_ROWS] a frame-stacked Camera ([F, 3] vectors, [F] scalars)."""
    c = cam_rows
    return Camera(origin=c[..., _C_ORIGIN:_C_ORIGIN + 3],
                  lower_left_corner=c[..., _C_LLC:_C_LLC + 3],
                  horizontal=c[..., _C_HORIZ:_C_HORIZ + 3],
                  vertical=c[..., _C_VERT:_C_VERT + 3],
                  right_axis=c[..., _C_RIGHT:_C_RIGHT + 3],
                  up_axis=c[..., _C_UP:_C_UP + 3],
                  lens_radius=c[..., _C_LENS], shutter_open=c[..., _C_SH_OPEN],
                  shutter_close=c[..., _C_SH_CLOSE])


def n_frames_of(cam_rows: torch.Tensor) -> int:
    return 1 if cam_rows.dim() == 1 else cam_rows.shape[0]


def bounce_plain(table: SphereTable, cam_rows: torch.Tensor, st: PathState,
                 salt, step, dims: Dims, *, cfg: RenderConfig,
                 lean: bool = False, stats=None) -> PathState:
    """The plain bounce: hit + sky, scatter, respawn in torch ops."""
    return p_bounce_step(table, unpack_camera(cam_rows), st, salt, step,
                         dims, cfg=cfg, hit_fn=hit_spheres_rows_plain,
                         lean=lean, stats=stats)


def bounce_multi_plain(table: SphereTable, cam_rows: torch.Tensor,
                       st: PathState, salt, step0, dims: Dims, *,
                       cfg: RenderConfig, k: int = _MULTI_K,
                       lean: bool = False, stats=None) -> PathState:
    """The plain k-bounce: ``k`` plain bounces at steps step0..step0+k-1."""
    return p_bounce_multi_step(table, unpack_camera(cam_rows), st, salt,
                               step0, dims, cfg=cfg,
                               hit_fn=hit_spheres_rows_plain, k=k, lean=lean,
                               stats=stats)


class StepParams(ctypes.Structure):  # csrc/common.cuh StepParams
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("kpp", ctypes.c_int32), ("kx", ctypes.c_int32),
        ("ky", ctypes.c_int32), ("max_depth", ctypes.c_int32),
        ("rr_start", ctypes.c_int32), ("eps", ctypes.c_float),
        ("reflect_thres", ctypes.c_float), ("refract_bias", ctypes.c_float),
        ("schlick_ni", ctypes.c_int32), ("n_frames", ctypes.c_int32),
    ]


def step_params(dims: Dims, cfg: RenderConfig, n_frames: int) -> StepParams:
    return StepParams(
        dims.width, dims.height, dims.kpp, dims.kx, dims.ky, dims.max_depth,
        dims.rr_start, float(np.float32(cfg.epsilon)),
        float(np.float32(cfg.reflect_thres)),
        float(np.float32(cfg.refract_discriminant_bias)),
        int(bool(cfg.schlick_uses_ni_over_nt)), n_frames)


STATE_FIELDS = ("origin", "direction", "time", "throughput", "radiance_sum",
                "depth", "sample", "pixel", "path_alive", "s_base", "s_quota")
_STATE_SPECS = dict(zip(STATE_FIELDS, zip(
    (torch.float32,) * 5 + (torch.int32,) * 3 + (torch.bool,) + (torch.int32,) * 2,
    (3, 3, 1, 3, 3, 1, 1, 1, 1, 1, 1))))


class StateRows(ctypes.Structure):  # csrc/common.cuh StateRows
    _fields_ = [(f, ctypes.c_void_p) for f in STATE_FIELDS]


def state_rows(st: PathState, dev, with_radiance: bool = True) -> StateRows:
    """Check the state's rows (dtype, shape, device, contiguity) and
    return their pointers; radiance is left null without ``with_radiance``."""
    n = st.origin.shape[1]
    ptrs = []
    for f in STATE_FIELDS:
        if f == "radiance_sum" and not with_radiance:
            ptrs.append(None)
            continue
        dt, rows = _STATE_SPECS[f]
        _build.check_tensor(getattr(st, f), f, dt, (rows, n), dev)
        ptrs.append(getattr(st, f).data_ptr())
    return StateRows(*ptrs)


def check_camera(cam_rows: torch.Tensor, dev) -> int:
    """Check a packed camera ([CAM_ROWS] or [F, CAM_ROWS]); returns F."""
    f = n_frames_of(cam_rows)
    shape = (CAM_ROWS,) if cam_rows.dim() == 1 else (f, CAM_ROWS)
    _build.check_tensor(cam_rows, "cam_rows", torch.float32, shape, dev)
    return f


class BounceArgs(ctypes.Structure):  # csrc/bounce.cu BounceArgs
    _fields_ = [("in_", StateRows),
                ("attrs", ctypes.c_void_p), ("active", ctypes.c_void_p),
                ("cam", ctypes.c_void_p), ("out_f", ctypes.c_void_p),
                ("out_i", ctypes.c_void_p), ("out_alive", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("n_spheres", ctypes.c_int),
                ("salt", ctypes.c_uint32), ("step", ctypes.c_int32),
                ("min_t", ctypes.c_float), ("p", StepParams),
                ("stats", ctypes.c_void_p), ("stream", ctypes.c_void_p)]


def _launch(table: SphereTable, cam_rows: torch.Tensor, st: PathState, salt,
            step, dims: Dims, cfg: RenderConfig, lean: bool, k: int, stats):
    """Launch bounce_kernel (k == 0) or bounce_multi_kernel (k bounces) on
    CUDA tensors; returns the new state and whether anything launched."""
    dev = st.origin.device
    if dev.type != "cuda":
        raise ValueError(f"bounce: unsupported device {dev}")
    n = st.origin.shape[1]
    s = table.attrs.shape[0]
    rows = state_rows(st, dev)
    _build.check_tensor(table.attrs, "attrs", torch.float32, (s, ATTR_COLS), dev)
    _build.check_tensor(table.active, "active", torch.bool, (s,), dev)
    n_frames = check_camera(cam_rows, dev)
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (2,), dev)

    out_f = torch.empty((13, n), dtype=torch.float32, device=dev)
    out_i = torch.empty((2, n), dtype=torch.int32, device=dev)
    alive = torch.empty((1, n), dtype=torch.bool, device=dev)
    launched = False
    if n:
        lib = _build.load()
        args = BounceArgs(
            rows, table.attrs.data_ptr(), table.active.data_ptr(),
            cam_rows.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
            alive.data_ptr(), n, s, int(salt) & 0xFFFFFFFF,
            int(np.int32(step)), float(cfg.min_hit_t),
            step_params(dims, cfg, n_frames),
            None if stats is None else stats.data_ptr(),
            _build.stream_handle(dev))
        if k:
            _build.check(lib.wrt_bounce_multi(ctypes.addressof(args),
                                              int(lean), k), "bounce_multi")
        else:
            _build.check(lib.wrt_bounce(ctypes.addressof(args), int(lean)),
                         "bounce")
        launched = True
    new = st._replace(origin=out_f[0:3], direction=out_f[3:6],
                      time=out_f[6:7], throughput=out_f[7:10],
                      radiance_sum=out_f[10:13], depth=out_i[0:1],
                      sample=out_i[1:2], path_alive=alive)
    return new, launched


def bounce(table: SphereTable, cam_rows: torch.Tensor, st: PathState, salt,
           step, dims: Dims, *, cfg: RenderConfig,
           lean: bool = False, stats=None) -> PathState:
    """One bounce (hit + sky + scatter + respawn) of every lane of ``st``;
    ``salt`` / ``step`` key the draws as in ``persistent._scatter_core``."""
    global LAUNCHES
    if st.origin.device.type == "cpu":
        return bounce_plain(table, cam_rows, st, salt, step, dims, cfg=cfg,
                            lean=lean, stats=stats)
    new, launched = _launch(table, cam_rows, st, salt, step, dims, cfg, lean,
                            0, stats)
    LAUNCHES += launched
    return new


def bounce_multi(table: SphereTable, cam_rows: torch.Tensor, st: PathState,
                 salt, step0, dims: Dims, *, cfg: RenderConfig,
                 k: int = _MULTI_K, lean: bool = False,
                 stats=None) -> PathState:
    """``k`` bounces of every lane at steps step0..step0+k-1 in one launch;
    equal to ``k`` calls of :func:`bounce`."""
    global MULTI_LAUNCHES
    if k < 1:
        raise ValueError(f"bounce_multi: k must be >= 1, got {k}")
    if st.origin.device.type == "cpu":
        return bounce_multi_plain(table, cam_rows, st, salt, step0, dims,
                                  cfg=cfg, k=k, lean=lean, stats=stats)
    new, launched = _launch(table, cam_rows, st, salt, step0, dims, cfg,
                            lean, k, stats)
    MULTI_LAUNCHES += launched
    return new
