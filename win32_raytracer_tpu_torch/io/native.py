"""ctypes binding of the native image encoder in ``native/librtnative.so``
(the reference's ``io/native.py``).

``native/rtnative.cpp`` holds a BMP encoder beside the reference-semantics
oracle (oracle.py).  :func:`io.image.write_image` tries it first and writes
the Python encoder's bytes, which are the same, when the library is not
built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "librtnative.so"),
    os.path.join(os.path.dirname(__file__), "librtnative.so"),
]

_lib = None
_checked = False


def load() -> Optional[ctypes.CDLL]:
    """The library, or None when it is not built; looked up once."""
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if not os.path.exists(p):
            continue
        try:
            lib = ctypes.CDLL(p)
        except OSError:
            continue
        lib.rt_encode_bmp.restype = ctypes.c_longlong
        lib.rt_encode_bmp.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong]
        _lib = lib
        break
    return _lib


def try_encode(ext: str, img: np.ndarray) -> Optional[bytes]:
    """The file bytes of u8 [H, W, 3] ``img`` from the native encoder; None
    when the library is not built or has no encoder for ``ext``."""
    lib = load()
    if lib is None or ext != ".bmp":
        return None
    h, w, _ = img.shape
    img = np.ascontiguousarray(img, dtype=np.uint8)
    cap = 14 + 40 + ((w * 3 + 3) & ~3) * h
    out = ctypes.create_string_buffer(cap)
    n = lib.rt_encode_bmp(img.ctypes.data, w, h, out, cap)
    if n <= 0:
        return None
    return out.raw[:n]
