"""Image file writers in pure numpy, byte-identical to the JAX package's
encoders (``win32_raytracer_tpu/io/image.py``): 24bpp bottom-up BGR BMP
(what stb_image_write emits for the reference's out.bmp, Game.cpp:27-43),
PNG and binary PPM."""

from __future__ import annotations

import os
import struct
import threading
import zlib

import numpy as np


def _as_u8_rgb(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] image, got {img.shape}")
    return img


def encode_bmp(image: np.ndarray) -> bytes:
    """u8 [H, W, 3] RGB -> 24bpp BMP (stb-compatible)."""
    img = _as_u8_rgb(image)
    h, w, _ = img.shape
    row_size = (w * 3 + 3) & ~3  # rows padded to 4 bytes
    data_size = row_size * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 14 + 40 + data_size, 0, 0, 14 + 40,
        40, w, h, 1, 24, 0, data_size, 2835, 2835, 0, 0,
    )
    bgr = img[::-1, :, ::-1]  # bottom-up BGR
    rows = np.zeros((h, row_size), np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    return header + rows.tobytes()


def encode_png(image: np.ndarray) -> bytes:
    """u8 [H, W, 3] RGB -> PNG (zlib, filter 0)."""
    img = _as_u8_rgb(image)
    h, w, _ = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1
    ).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def encode_ppm(image: np.ndarray) -> bytes:
    """Binary PPM (P6)."""
    img = _as_u8_rgb(image)
    h, w, _ = img.shape
    return f"P6\n{w} {h}\n255\n".encode() + img.tobytes()


_ENCODERS = {".bmp": encode_bmp, ".png": encode_png, ".ppm": encode_ppm}


def write_image(path: str, image: np.ndarray) -> None:
    """Write a u8 [H, W, 3] RGB image; format chosen by extension.  The
    file is written beside ``path`` and renamed into place."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _ENCODERS:
        raise ValueError(f"unsupported image format {ext!r} (use .bmp/.png/.ppm)")
    data = _ENCODERS[ext](_as_u8_rgb(image))
    tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}{ext}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
