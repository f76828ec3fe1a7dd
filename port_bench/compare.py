"""The comparison that decides ``correct``.

A render is Monte Carlo: the port and the plain reference draw their own
numbers, so their images agree in distribution, not pixel for pixel.  Each
image P the port returned is held against two reference images R1 and R2
of the same camera, size and samples, made with independent seeds.  With
D = P - R1 and N = R2 - R1 (u8 values as floats), a sound P makes D and N
alike in distribution, and two numbers test that:

* ``z_max`` (bias): the image is cut into blocks of ``BLOCK`` x ``BLOCK``
  pixels; in each block and channel the mean of D is divided by its noise,
  sqrt(mean(N^2) / pixels), with mean(N^2) floored at ``NOISE_FLOOR``
  (about two u8 roundings) where the block is noiseless.  The largest
  absolute value over blocks and channels.  A wrong material, geometry,
  sky, camera, exchange or an altered region reads far above a sound
  image's ~4-6.
* ``noise_excess`` (spread): mean(D^2) / mean(N^2) - 1 over the image.  A
  sound image reads about 0; one rendered with half its samples reads
  about +0.5, since its own noise is twice the reference's.

A call's numbers are the largest over the images it returned; a run's the
largest over the calls it compared.
"""

from __future__ import annotations

import numpy as np

BLOCK = 16
NOISE_FLOOR = 0.5
NUMBERS = ("z_max", "noise_excess")


def image_numbers(p: np.ndarray, r1: np.ndarray, r2: np.ndarray) -> dict:
    """``z_max`` and ``noise_excess`` of one u8 image [H, W, 3]."""
    if p.shape != r1.shape or p.dtype != np.uint8:
        return {"z_max": float("inf"), "noise_excess": float("inf")}
    d = p.astype(np.float64) - r1
    n = r2.astype(np.float64) - r1
    h, w, _ = d.shape
    hb, wb = -(-h // BLOCK), -(-w // BLOCK)

    def blocks(x):
        pad = np.full((hb * BLOCK, wb * BLOCK, 3), np.nan)
        pad[:h, :w] = x
        return pad.reshape(hb, BLOCK, wb, BLOCK, 3)

    db, nb = blocks(d), blocks(n * n)
    count = np.sum(~np.isnan(db), axis=(1, 3))
    mean_d = np.nansum(db, axis=(1, 3)) / count
    noise = np.maximum(np.nansum(nb, axis=(1, 3)) / count, NOISE_FLOOR)
    z = np.abs(mean_d) / np.sqrt(noise / count)
    excess = float((d * d).mean() / max((n * n).mean(), 1e-12) - 1.0)
    return {"z_max": float(z.max()), "noise_excess": excess}


def worst(readings) -> dict:
    """The largest of each number over several readings."""
    out = {k: -float("inf") for k in NUMBERS}
    for r in readings:
        for k in NUMBERS:
            out[k] = max(out[k], r[k])
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number is at or below its limit."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
