"""Image file writers and readers in numpy, with the native BMP encoder
tried first (io/native.py), as the JAX package's ``io/image.py`` does.  The
writers are byte-identical to the JAX package's encoders: 24bpp bottom-up
BGR BMP (what stb_image_write emits for the reference's out.bmp,
Game.cpp:27-43), PNG and binary PPM.  :func:`read_image` reads any of them
back (by magic bytes), as ``animation.render_animation``'s resume path
does."""

from __future__ import annotations

import os
import struct
import threading
import zlib

import numpy as np

from . import native


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
    native encoder (io/native.py) goes first where it is built and has the
    format, else the Python encoder here: the same bytes.  The file is
    written beside ``path`` and renamed into place."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _ENCODERS:
        raise ValueError(f"unsupported image format {ext!r} (use .bmp/.png/.ppm)")
    img = _as_u8_rgb(image)
    data = native.try_encode(ext, img)
    if data is None:
        data = _ENCODERS[ext](img)
    tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}{ext}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_png(path: str, data: bytes | None = None) -> np.ndarray:
    """Read an 8-bit RGB (color type 2, non-interlaced) PNG back to u8
    [H, W, 3].  All five scanline filters decode (Average and Paeth a byte
    at a time); ``data`` passes bytes already read."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    buf = data
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos = 8
    w = h = None
    idat = []
    while pos + 8 <= len(buf):
        ln, tag = struct.unpack_from(">I4s", buf, pos)
        payload = buf[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, comp, filt, ilace = struct.unpack(
                ">IIBBBBB", payload)
            if (depth, ctype, comp, filt, ilace) != (8, 2, 0, 0, 0):
                raise ValueError(
                    "only 8-bit RGB non-interlaced PNG supported "
                    f"(depth={depth} color={ctype} interlace={ilace})")
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError("malformed PNG: missing IHDR chunk")
    if not idat:
        raise ValueError("malformed PNG: no IDAT data")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * 3)
    out = np.zeros((h, w * 3), np.uint8)
    for y in range(h):
        ftype = rows[y, 0]
        cur = rows[y, 1:].astype(np.int32)
        prev = (out[y - 1].astype(np.int32) if y
                else np.zeros(w * 3, np.int32))
        if ftype == 0:
            line = cur
        elif ftype == 2:                        # Up
            line = (cur + prev) & 0xFF
        elif ftype == 1:                        # Sub: per-channel cumsum
            line = np.cumsum(cur.reshape(w, 3), axis=0,
                             dtype=np.int64).reshape(-1) & 0xFF
        elif ftype in (3, 4):                   # Average / Paeth
            line = np.zeros(w * 3, np.int32)
            for x in range(w * 3):
                a = line[x - 3] if x >= 3 else 0
                b = prev[x]
                if ftype == 3:
                    line[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = prev[x - 3] if x >= 3 else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                    line[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = line.astype(np.uint8)
    return out.reshape(h, w, 3)


def read_ppm(path: str, data: bytes | None = None) -> np.ndarray:
    """Read a binary P6 PPM (maxval 255) back to u8 [H, W, 3]."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    buf = data
    if not buf.startswith(b"P6"):
        raise ValueError("not a P6 PPM file")
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(buf) and buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":            # comment line
            pos = buf.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(buf) and not buf[end:end + 1].isspace():
            end += 1
        fields.append(int(buf[pos:end]))
        pos = end
    sep = buf[pos:pos + 1]
    if not sep.isspace():
        raise ValueError("malformed P6 header: no whitespace after maxval")
    pos += 1
    if sep == b"\r" and buf[pos:pos + 1] == b"\n":
        pos += 1  # a \r\n header: the pixels start one byte later
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"only maxval 255 supported, got {maxval}")
    if len(buf) - pos < h * w * 3:
        raise ValueError("truncated P6 pixel data")
    return np.frombuffer(buf, np.uint8, h * w * 3, pos).reshape(
        h, w, 3).copy()


def read_bmp(path: str, data: bytes | None = None) -> np.ndarray:
    """Read a 24bpp uncompressed BMP back to u8 [H, W, 3] RGB."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    buf = data
    if buf[:2] != b"BM":
        raise ValueError("not a BMP file")
    data_offset = struct.unpack_from("<I", buf, 10)[0]
    w, h = struct.unpack_from("<ii", buf, 18)
    bpp = struct.unpack_from("<H", buf, 28)[0]
    if bpp != 24:
        raise ValueError(f"only 24bpp BMP supported, got {bpp}")
    row_size = (w * 3 + 3) & ~3
    flip = h > 0
    h = abs(h)
    rows = np.frombuffer(buf, np.uint8, row_size * h, data_offset)
    img = rows.reshape(h, row_size)[:, : w * 3].reshape(h, w, 3)[:, :, ::-1]
    return (img[::-1] if flip else img).copy()


def read_image(path: str) -> np.ndarray:
    """Read any image this module writes (BMP, PNG or PPM, by its magic
    bytes) back to u8 [H, W, 3]."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"BM":
        return read_bmp(path, data=buf)
    if buf[:8] == b"\x89PNG\r\n\x1a\n":
        return read_png(path, data=buf)
    if buf[:2] == b"P6":
        return read_ppm(path, data=buf)
    raise ValueError(f"unrecognized image format in {path!r}")
