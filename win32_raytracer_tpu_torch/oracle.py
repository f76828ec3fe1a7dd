"""ctypes wrapper of the native reference-semantics oracle renderer (the
reference's ``oracle.py``, with no jax).

``native/rtnative.cpp::rt_oracle_render`` reproduces the tracing semantics
of the reference CPU renderer (win32-raytracer/RayTracer.cpp:392-959):
recursion limits, material quirks, LCG rejection sampling, tonemap.  Golden
tests compare the port's renders with it.  :func:`build_native` builds the
library with ``make -C native`` from the repository's own sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from .config import RenderConfig
from .scene.spheres import SphereScene

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "librtnative.so")


class _Scene(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("c1", ctypes.POINTER(ctypes.c_float)),
        ("c2", ctypes.POINTER(ctypes.c_float)),
        ("t1", ctypes.POINTER(ctypes.c_float)),
        ("t2", ctypes.POINTER(ctypes.c_float)),
        ("radius", ctypes.POINTER(ctypes.c_float)),
        ("mat_id", ctypes.POINTER(ctypes.c_int)),
        ("albedo", ctypes.POINTER(ctypes.c_float)),
        ("fuzz", ctypes.POINTER(ctypes.c_float)),
        ("ior", ctypes.POINTER(ctypes.c_float)),
    ]


class _Camera(ctypes.Structure):
    _fields_ = [
        ("look_from", ctypes.c_float * 3),
        ("look_to", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("vfov_deg", ctypes.c_float),
        ("aspect", ctypes.c_float),
        ("aperture", ctypes.c_float),
        ("focus_dist", ctypes.c_float),
        ("shutter_open", ctypes.c_float),
        ("shutter_close", ctypes.c_float),
    ]


class _Opts(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("max_depth", ctypes.c_int),
        ("seed", ctypes.c_uint32),
        ("deterministic", ctypes.c_int),
        ("reflect_thres", ctypes.c_float),
        ("refract_bias", ctypes.c_float),
        ("schlick_ni_over_nt", ctypes.c_int),
        ("lane_truncate", ctypes.c_int),
    ]


def build_native(force: bool = False) -> bool:
    """Build ``native/librtnative.so`` with make; whether it is there."""
    if os.path.exists(_LIB_PATH) and not force:
        return True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "librtnative.so"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    return os.path.exists(_LIB_PATH)


_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    """The library (built if need be), or None when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    for name in ("rt_oracle_render", "rt_oracle_render_f32"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(_Scene), ctypes.POINTER(_Camera),
                       ctypes.POINTER(_Opts), ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _pack_scene(scene: SphereScene):
    """The scene's active rows as contiguous arrays for the C ABI: the
    struct and the arrays it points into (keep both alive)."""
    def host(x, dtype):
        return np.asarray(x.detach().cpu().numpy(), dtype)

    act = host(scene.active, bool)
    arrs = {f: np.ascontiguousarray(host(getattr(scene, name), dt)[act])
            for f, name, dt in (
                ("c1", "center1", np.float32), ("c2", "center2", np.float32),
                ("t1", "t1", np.float32), ("t2", "t2", np.float32),
                ("radius", "radius", np.float32),
                ("mat_id", "mat_id", np.int32),
                ("albedo", "albedo", np.float32),
                ("fuzz", "fuzz", np.float32), ("ior", "ior", np.float32))}
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    sc = _Scene(n=int(act.sum()),
                **{f: a.ctypes.data_as(ip if f == "mat_id" else fp)
                   for f, a in arrs.items()})
    return sc, arrs


def oracle_render(
    scene: SphereScene,
    look_from, look_to, up,
    vfov_deg: float, aperture: float, focus_dist: float,
    cfg: RenderConfig,
    deterministic: bool = False,
    lane_truncate: int = 0,
    shutter=(0.0, 0.05),
    linear: bool = False,
) -> np.ndarray:
    """Render through the native oracle: u8 [H, W, 3], or f32 when
    ``linear``."""
    lib = load()
    if lib is None:
        raise RuntimeError("librtnative.so unavailable (run `make -C native`)")
    sc, keepalive = _pack_scene(scene)
    cam = _Camera(
        look_from=(ctypes.c_float * 3)(*[float(v) for v in look_from]),
        look_to=(ctypes.c_float * 3)(*[float(v) for v in look_to]),
        up=(ctypes.c_float * 3)(*[float(v) for v in up]),
        vfov_deg=vfov_deg, aspect=cfg.width / cfg.height,
        aperture=aperture, focus_dist=focus_dist,
        shutter_open=shutter[0], shutter_close=shutter[1],
    )
    opts = _Opts(
        width=cfg.width, height=cfg.height, spp=cfg.samples,
        max_depth=cfg.max_depth, seed=cfg.seed or 666,
        deterministic=int(deterministic),
        reflect_thres=cfg.reflect_thres,
        refract_bias=cfg.refract_discriminant_bias,
        schlick_ni_over_nt=int(cfg.schlick_uses_ni_over_nt),
        lane_truncate=lane_truncate,
    )
    if linear:
        out = np.empty((cfg.height, cfg.width, 3), np.float32)
        fn = lib.rt_oracle_render_f32
    else:
        out = np.empty((cfg.height, cfg.width, 3), np.uint8)
        fn = lib.rt_oracle_render
    fn(ctypes.byref(sc), ctypes.byref(cam), ctypes.byref(opts),
       out.ctypes.data)
    del keepalive
    return out
