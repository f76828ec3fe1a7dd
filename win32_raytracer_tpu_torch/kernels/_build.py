"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` into one shared library with a plain
C interface and loaded with ``ctypes``; nothing includes PyTorch's headers,
so a build takes seconds: one ``nvcc -c`` per source, all started together,
then one link.  The library lands in ``_build/`` inside the package, named
by a hash of the sources and flags, and is built on first use.  Every C
entry returns ``cudaGetLastError()`` after its launch and the wrappers
raise on anything but 0 (:func:`check`).

Flags: Hopper only (``sm_90a``).  ``--fmad=false`` keeps every multiply and
add separately rounded, as the plain torch versions round them, so a kernel
and its plain version agree to the last place on the pair tests; and
``--use_fast_math`` is never passed, which keeps sqrtf, division and the
transcendentals IEEE-accurate and denormals intact.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc's output of the build this process made ("" if none)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ on a machine with the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libwrt_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists;
    returns its path.  Raises with nvcc's output if the build fails."""
    global build_log, build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{path[:-3]}.tmp{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for i, src in enumerate(_sources()):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tag}.{i}.o", src]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{out}")
    objs = [cmd[cmd.index("-o") + 1] for cmd, _ in jobs]
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", f"{tag}.so", *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                          f"{logs[-1]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(f"{tag}.so", path)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.wrt_hit_spheres.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_hit_spheres.restype = ctypes.c_int
            lib.wrt_bounce.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_bounce.restype = ctypes.c_int
            lib.wrt_bounce_multi.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int]
            lib.wrt_bounce_multi.restype = ctypes.c_int
            lib.wrt_hit_sky.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_hit_sky.restype = ctypes.c_int
            lib.wrt_scatter_respawn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_scatter_respawn.restype = ctypes.c_int
            lib.wrt_hit_triangles.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_hit_triangles.restype = ctypes.c_int
            lib.wrt_hit_spheres_cols.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_hit_spheres_cols.restype = ctypes.c_int
            lib.wrt_hit_triangles_cols.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_hit_triangles_cols.restype = ctypes.c_int
            lib.wrt_hit_tri_grid.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int]
            lib.wrt_hit_tri_grid.restype = ctypes.c_int
            lib.wrt_hit_grid.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_hit_grid.restype = ctypes.c_int
            lib.wrt_hit_grid_schedule.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wrt_hit_grid_schedule.restype = ctypes.c_int
            lib.wrt_tri_grid_schedule.argtypes = [ctypes.c_void_p]
            lib.wrt_tri_grid_schedule.restype = ctypes.c_int
            lib.wrt_threefry_uniform.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.wrt_threefry_uniform.restype = ctypes.c_int
            lib.wrt_error_string.argtypes = [ctypes.c_int]
            lib.wrt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = load().wrt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device`` (what the kernels take)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
