"""The plain reference with stratified sampling and Russian roulette: the
path tracer of ``render.py`` (its scene, hit, scatter, sky and camera,
imported from it unchanged) with the two settings a progressive 4K render
turns on, written from the port's rules and independent of its code.

Settings followed (``FOLLOWS``, keyword arguments of :func:`render`, as
the port's ``RenderConfig`` names them):

* ``stratify``: a pixel's ``spp`` samples cover a ``kx`` x ``ky`` grid of
  its area once each, ``kx`` the largest divisor of ``spp`` at or below
  sqrt(spp) and ``ky = spp / kx`` (one stratum, the whole pixel, at 1
  spp).  Sample s of a pixel takes the stratum (s mod kx, (s div kx) mod
  ky) and jitters within it: u = (x + (sx + r0) / kx) / W and v = (H - y +
  (sy + r1) / ky) / H, the flip of ``render.py`` kept;
* ``russian_roulette`` and ``rr_start_depth``: after a scatter, on paths
  still alive whose depth (scatter events so far) is at least
  ``rr_start_depth``, p = clamp(max channel of the throughput, 0.05, 1);
  the path survives if a uniform draw is below p, and its throughput is
  then divided by p.  The throughput is the one after the scatter's
  attenuation.  A path past ``max_depth + 1`` scatter events is black
  whether or not it survived the last roulette.

Where its draws depart from the port's (the distributions are the same):

* its own ``torch.Generator``, not the port's counter-based hash draws;
* samples keyed by pixel (lane = pixel x spp + s, and s picks the
  stratum), not by lane: the port keys a sample's stratum on its lane's
  first global sample index plus the lane's sample count, over its lanes
  a pixel;
* the roulette's draw is a fifth column beside the scatter's four, drawn
  only when the roulette plays.

Float32 with TF32 off for both matrix products and cuDNN, as
``render.py``; ``dtype`` of the scene sets the precision (bfloat16 is the
control of ``control.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from port_bench.reference.render import (  # noqa: F401 (RefScene: the harness's)
    RefScene, _camera_tensors, _scatter, _sky, hit)

# The port's RenderConfig fields this reference reproduces.
FOLLOWS = ("stratify", "russian_roulette", "rr_start_depth")

RR_FLOOR = 0.05     # the roulette's least survival probability


def stratify_grid(spp: int) -> tuple:
    """(kx, ky): kx * ky == spp, kx the largest divisor <= sqrt(spp)."""
    kx = max(c for c in range(1, math.isqrt(spp) + 1) if spp % c == 0)
    return kx, spp // kx


def render(scene: RefScene, cams: List[dict], width: int, height: int,
           spp: int, max_depth: int, seed: int,
           lanes_per_chunk: int = 1 << 21, stats: Optional[dict] = None, *,
           stratify: bool = False, russian_roulette: bool = False,
           rr_start_depth: int = 3) -> np.ndarray:
    """u8 images [F, H, W, 3], one per camera (``render.render``'s
    contract, ``stats`` included), with the followed settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, dt = scene.device, scene.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    cam = _camera_tensors(cams, dev, dt)
    kx, ky = stratify_grid(spp) if stratify else (1, 1)
    n_pix = len(cams) * height * width
    pix_per_chunk = max(1, lanes_per_chunk // spp)
    out = torch.empty((n_pix, 3), device=dev, dtype=torch.float32)
    segments = 0
    for p0 in range(0, n_pix, pix_per_chunk):
        p1 = min(n_pix, p0 + pix_per_chunk)
        lanes = (p1 - p0) * spp
        lane = torch.arange(lanes, device=dev)
        pix = p0 + lane // spp
        s = lane % spp
        frame = pix // (height * width)
        y = (pix // width) % height
        x = pix % width
        u = torch.rand((lanes, 5), generator=gen, device=dev).to(dt)
        jx = (((s % kx).to(dt) + u[:, 0]) / kx) if stratify else u[:, 0]
        jy = ((((s // kx) % ky).to(dt) + u[:, 1]) / ky) if stratify else u[:, 1]
        uu = (x.to(dt) + jx) / width
        vv = ((height - y).to(dt) + jy) / height
        c = {k: v[frame] for k, v in cam.items()}
        time = c["shutter_open"] + (c["shutter_close"] - c["shutter_open"]) * u[:, 2]
        rr = torch.sqrt(u[:, 3])
        th = (2.0 * math.pi) * u[:, 4]
        lens = c["lens_radius"][:, None]
        o = (c["origin"] + c["right_axis"] * (rr * torch.cos(th))[:, None] * lens
             + c["up_axis"] * (rr * torch.sin(th))[:, None] * lens)
        d = (c["lower_left_corner"] + uu[:, None] * c["horizontal"]
             + vv[:, None] * c["vertical"] - o)
        thr = torch.ones((lanes, 3), device=dev, dtype=dt)
        rad = torch.zeros((lanes, 3), device=dev, dtype=dt)
        live = torch.arange(lanes, device=dev)
        for depth in range(1, max_depth + 2):
            if live.numel() == 0:
                break
            segments += live.numel()
            is_hit, p, n, mat, alb, fz, io = hit(scene, o, d, time)
            miss = ~is_hit
            rad.index_add_(0, live[miss], thr[miss] * _sky(d[miss]))
            keep = is_hit
            live, o, d, time, thr = live[keep], o[keep], d[keep], time[keep], thr[keep]
            # ``depth`` scatter events after this one; a path past
            # max_depth + 1 of them ends black, so no roulette plays there.
            roulette = (russian_roulette and depth >= rr_start_depth
                        and depth <= max_depth)
            u = torch.rand((live.numel(), 5 if roulette else 4), generator=gen,
                           device=dev).to(dt)
            o, d, att, alive = _scatter(d, p[keep], n[keep], mat[keep],
                                        alb[keep], fz[keep], io[keep], u)
            thr = thr * att
            if roulette:
                prob = torch.clamp(thr.amax(dim=1), RR_FLOOR, 1.0)
                thr = thr / prob[:, None]
                alive = alive & (u[:, 4] < prob)
            live, o, d, time, thr = live[alive], o[alive], d[alive], time[alive], thr[alive]
        mean = rad.float().reshape(p1 - p0, spp, 3).sum(1) / spp
        out[p0:p1] = mean
    if stats is not None:
        stats["segments"] = stats.get("segments", 0) + segments
        stats["primary"] = stats.get("primary", 0) + n_pix * spp
    c = torch.sqrt(torch.clamp_min(out, 0.0))
    u8 = torch.clamp(torch.floor(255.99 * c), 0, 255).to(torch.uint8)
    return u8.reshape(len(cams), height, width, 3).cpu().numpy()
