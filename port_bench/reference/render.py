"""The plain reference: a path tracer in plain PyTorch, written from the
C++ reference's semantics (RayTracer.cpp) and independent of the port.

It reads the scene arrays and cameras the benchmark makes
(``scenes/``), draws its own random numbers from a ``torch.Generator``,
and returns u8 images.  Its noise is its own, so it agrees with the port
in distribution, not pixel for pixel; ``compare.py`` judges the port's
images against two independent reference images.

Semantics kept (each is what the port must reproduce):

* camera: u = (x + r0) / W, v = (H - y + r1) / H (the reference flips by
  H - y), shutter time uniform on the camera's interval, a lens disc of
  radius aperture / 2 (RayTracer.cpp:276-288, 934-944);
* spheres: the near root only, ``disc >= 0``, ``t > 0.001``; centres move
  linearly over [t1, t2]; the normal is (p - c) / r, so a negative radius
  flips it (RayTracer.cpp:433-589);
* triangles: two-sided Moller-Trumbore, |det| >= 1e-9, unit e1 x e2
  normal; a triangle wins over a sphere only when strictly nearer;
* scatter (RayTracer.cpp:604-688): lambertian (1 - eps) n + ball from
  p + eps n; metal reflect + fuzz ball, absorbed when it points into the
  surface; dielectric with Schlick of ni_over_nt, reflect when
  0.05 + r < prob, the 2.0 discriminant and the reference's origin
  offsets;
* a miss adds throughput x sky (RayTracer.cpp:690-701); at most
  ``max_depth + 1`` scatter events, a path alive after them is black;
* the mean over samples, sqrt gamma, floor(255.99 c) to u8.

Speed, without kernels: lanes are compacted as paths end, and the sphere
sweep expands its dot products into two small matrix products (TF32 off)
that pick the nearest sphere; the winner's root is then taken again
directly.  Triangles are grouped 64 to a block in Morton order of their
centroids, each block boxed; a ray tests the boxes, then the triangles of
the boxes it enters nearer than its best hit.

``dtype`` sets the precision of everything but the draws and the final
mean: float32 is the reference, bfloat16 the control (``control.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

EPS = 1e-5
MIN_T = 0.001
REFLECT_THRES = 0.05
REFRACT_BIAS = 2.0
DET_EPS = 1e-9
BIG = 1e30
LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
BLOCK = 64              # triangles per box
SWEEP_RAYS = 1 << 15    # rays per sphere-sweep matrix [rays, spheres]
PAIR_BATCH = 1 << 15    # (ray, box) pairs per triangle batch

# The port's RenderConfig fields this reference reproduces (keyword
# arguments of ``render``): none, so it holds the port's defaults.
FOLLOWS = ()


def _morton(p: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points scaled into their bounding box."""
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(p), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


class RefScene:
    """The active rows of a scene dict, on ``device`` in ``dtype``."""

    def __init__(self, scene: dict, device, dtype=torch.float32):
        # The sweep's matrix products run in full f32 on a card, not TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device, self.dtype = torch.device(device), dtype

        def t(x, dt=None):
            return torch.as_tensor(np.ascontiguousarray(x), device=device,
                                   dtype=dt or dtype)

        sp = scene["spheres"]
        act = sp["active"]
        c1 = sp["center1"][act].astype(np.float64)
        c2 = sp["center2"][act].astype(np.float64)
        t1 = sp["t1"][act].astype(np.float64)
        t2 = sp["t2"][act].astype(np.float64)
        w = (c2 - c1) / (t2 - t1)[:, None]       # centre(t) = c0 + w t
        c0 = c1 - w * t1[:, None]
        r = sp["radius"][act].astype(np.float64)
        self.n_spheres = int(act.sum())
        self.c0, self.w, self.radius = t(c0), t(w), t(r)
        self.s_mat = t(sp["mat_id"][act], torch.int64)
        self.s_albedo, self.s_fuzz = t(sp["albedo"][act]), t(sp["fuzz"][act])
        self.s_ior = t(sp["ior"][act])
        # b = d.o - [d, t d] . [c0; w]
        self.b_w = t(np.concatenate([c0, w], 1).T)
        # |o - c(t)|^2 - r^2 = |o|^2 + [o, t o, t, t^2] . k + (|c0|^2 - r^2)
        self.c_w = t(np.concatenate(
            [-2 * c0, -2 * w, 2 * (c0 * w).sum(1, keepdims=True),
             (w * w).sum(1, keepdims=True)], 1).T)
        self.c_k = t((c0 * c0).sum(1) - r * r)

        self.tri = None
        tr = scene.get("triangles")
        if tr is not None:
            ta = tr["active"]
            v0, e1, e2 = tr["v0"][ta], tr["e1"][ta], tr["e2"][ta]
            order = np.argsort(_morton(v0 + (e1 + e2) / 3), kind="stable")
            n = len(order)
            nb = -(-n // BLOCK)
            pad = nb * BLOCK - n
            idx = np.concatenate([order, np.full(pad, order[-1])])
            live = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
            v0, e1, e2 = v0[idx], e1[idx] * live[:, None], e2[idx] * live[:, None]
            pts = np.stack([v0, v0 + e1, v0 + e2], 1).reshape(nb, BLOCK * 3, 3)
            lo, hi = pts.min(1), pts.max(1)
            slack = 1e-4 * (1.0 + np.abs(np.concatenate([lo, hi])).max())
            self.tri = {
                "v0": t(v0.reshape(nb, BLOCK, 3)),
                "e1": t(e1.reshape(nb, BLOCK, 3)),
                "e2": t(e2.reshape(nb, BLOCK, 3)),
                "lo": t(lo - slack), "hi": t(hi + slack),
                "mat": t(tr["mat_id"][ta][idx], torch.int64),
                "albedo": t(tr["albedo"][ta][idx]),
                "fuzz": t(tr["fuzz"][ta][idx]), "ior": t(tr["ior"][ta][idx]),
            }
            n_ = np.cross(e1, e2).astype(np.float64)
            n_ /= np.maximum(np.linalg.norm(n_, axis=1, keepdims=True), 1e-30)
            self.tri["normal"] = t(n_)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalize(a):
    return a / torch.clamp_min(torch.sqrt(_dot(a, a)), 1e-37)[:, None]


def _spheres(sc: RefScene, o, d, tm):
    """(t [n], winner [n] int64) of the nearest sphere; t = BIG on a miss."""
    n = o.shape[0]
    best_t = torch.full((n,), BIG, device=o.device, dtype=o.dtype)
    best_i = torch.zeros((n,), device=o.device, dtype=torch.int64)
    for r0 in range(0, n, SWEEP_RAYS):
        oo, dd, tt = o[r0:r0 + SWEEP_RAYS], d[r0:r0 + SWEEP_RAYS], tm[r0:r0 + SWEEP_RAYS]
        tcol = tt[:, None]
        b = _dot(dd, oo)[:, None] - torch.cat([dd, dd * tcol], 1) @ sc.b_w
        c = (_dot(oo, oo)[:, None]
             + torch.cat([oo, oo * tcol, tcol, tcol * tcol], 1) @ sc.c_w
             + sc.c_k[None, :])
        a = _dot(dd, dd)[:, None]
        disc = b * b - a * c
        t = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / a
        t = torch.where((disc >= 0) & (t > MIN_T), t, BIG)
        tv, ti = t.min(1)
        best_t[r0:r0 + SWEEP_RAYS], best_i[r0:r0 + SWEEP_RAYS] = tv, ti
    # The winner's root again, directly (no cancellation in the expansion).
    hit = best_t < BIG
    cen = sc.c0[best_i] + sc.w[best_i] * tm[:, None]
    oc = o - cen
    a = _dot(d, d)
    b = _dot(oc, d)
    r = sc.radius[best_i]
    disc = b * b - a * (_dot(oc, oc) - r * r)
    t = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / a
    exact = hit & (disc >= 0) & (t > MIN_T)
    best_t = torch.where(exact, t, best_t)
    return best_t, best_i


def _triangles(sc: RefScene, o, d, best_t):
    """(t [n], winner [n] int64) of the nearest triangle nearer than
    ``best_t``; t = BIG where none."""
    tr = sc.tri
    n = o.shape[0]
    out_t = torch.full((n,), BIG, device=o.device, dtype=o.dtype)
    out_i = torch.zeros((n,), device=o.device, dtype=torch.int64)
    tiny = torch.tensor(1e-30, device=o.device, dtype=o.dtype)
    rays, ts, tris = [], [], []
    for r0 in range(0, n, SWEEP_RAYS):
        oo, dd = o[r0:r0 + SWEEP_RAYS], d[r0:r0 + SWEEP_RAYS]
        dsafe = torch.where(dd.abs() < tiny, torch.copysign(tiny, dd), dd)
        inv = 1.0 / dsafe
        ta = (tr["lo"][None] - oo[:, None]) * inv[:, None]
        tb = (tr["hi"][None] - oo[:, None]) * inv[:, None]
        near = torch.minimum(ta, tb).amax(2)
        far = torch.maximum(ta, tb).amin(2)
        cap = best_t[r0:r0 + SWEEP_RAYS, None]
        ri, bi = ((near <= far) & (far > MIN_T) & (near < cap)).nonzero(
            as_tuple=True)
        for p0 in range(0, ri.shape[0], PAIR_BATCH):
            r_ = ri[p0:p0 + PAIR_BATCH] + r0
            b_ = bi[p0:p0 + PAIR_BATCH]
            po, pd = o[r_][:, None], d[r_][:, None]
            v0, e1, e2 = tr["v0"][b_], tr["e1"][b_], tr["e2"][b_]
            pvec = _cross(pd.expand_as(e2), e2)
            det = (e1 * pvec).sum(2)
            ok = det.abs() >= DET_EPS
            inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
            tvec = po - v0
            u = (tvec * pvec).sum(2) * inv_det
            qvec = _cross(tvec, e1)
            v = (pd * qvec).sum(2) * inv_det
            t = (e2 * qvec).sum(2) * inv_det
            valid = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > MIN_T)
            tp, kp = torch.where(valid, t, BIG).min(1)
            rays.append(r_)
            ts.append(tp)
            tris.append(b_ * BLOCK + kp)
    if rays:
        r_, tp, ti = torch.cat(rays), torch.cat(ts), torch.cat(tris)
        out_t.scatter_reduce_(0, r_, tp, reduce="amin")
        win = (tp < BIG) & (tp == out_t[r_])
        out_i.index_put_((r_[win],), ti[win])
    return out_t, out_i


def _sky(d):
    t = 0.5 * (_normalize(d)[:, 1] + 1.0)
    tint = torch.tensor([0.5, 0.7, 1.0], device=d.device, dtype=d.dtype)
    return (1.0 - t)[:, None] + t[:, None] * tint[None]


def _ball(u):
    z = 1.0 - 2.0 * u[:, 0]
    phi = (2.0 * math.pi) * u[:, 1]
    r = torch.pow(u[:, 2], 1.0 / 3.0)
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * s * torch.cos(phi), r * s * torch.sin(phi), r * z], 1)


def _reflect(v, n):
    return v - (2.0 * _dot(v, n))[:, None] * n


def _scatter(d, p, n, mat, albedo, fuzz, ior, u):
    """(origin, direction, attenuation, alive) of one scatter event."""
    ball = _ball(u[:, 0:3])
    lam_o = p + EPS * n
    lam_d = (1.0 - EPS) * n + ball
    met_d = _reflect(d, n) + fuzz[:, None] * ball
    met_ok = _dot(met_d, n) > 0.0

    to_light = _normalize(-d)
    entering = _dot(to_light, n) > 0.0
    ni = torch.where(entering, 1.0 / ior, ior)
    rfn = torch.where(entering[:, None], n, -n)
    off = torch.where(entering[:, None], -EPS * n, EPS * n)
    cosine = _dot(to_light, rfn)
    r0 = ((1.0 - ni) / (1.0 + ni)) ** 2
    prob = r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)
    reflected = (REFLECT_THRES + u[:, 3]) < prob
    dt = _dot(to_light, rfn)
    disc = REFRACT_BIAS - ni * ni * (1.0 - dt * dt)
    refr_ok = disc > 0.0
    refr = (ni[:, None] * (to_light - rfn * dt[:, None])
            - rfn * torch.sqrt(torch.clamp_min(disc, 0.0))[:, None])
    die_d = torch.where(reflected[:, None], _reflect(d, n),
                        torch.where(refr_ok[:, None], refr, _reflect(d, rfn)))
    die_o = torch.where((reflected | ~refr_ok)[:, None], p - off, p + off)

    is_met = (mat == METAL)[:, None]
    is_die = (mat == DIELECTRIC)[:, None]
    origin = torch.where(is_die, die_o, lam_o)
    direction = torch.where(is_die, die_d, torch.where(is_met, met_d, lam_d))
    att = torch.where(is_die, torch.ones_like(albedo), albedo)
    alive = torch.where(mat == METAL, met_ok, torch.ones_like(met_ok))
    return origin, direction, att, alive


def hit(sc: RefScene, o, d, tm):
    """(hit [n], point, normal, mat, albedo, fuzz, ior) of the nearest
    surface."""
    st, si = _spheres(sc, o, d, tm)
    t = st
    point_n = None
    if sc.tri is not None:
        tt, ti = _triangles(sc, o, d, st)
        take = tt < st
        t = torch.where(take, tt, st)
        point_n = (take, ti)
    is_hit = t < BIG
    tsafe = torch.where(is_hit, t, torch.zeros_like(t))
    p = o + tsafe[:, None] * d
    cen = sc.c0[si] + sc.w[si] * tm[:, None]
    r = sc.radius[si]
    n = (p - cen) / torch.where(r == 0, torch.ones_like(r), r)[:, None]
    mat, alb, fz, io = sc.s_mat[si], sc.s_albedo[si], sc.s_fuzz[si], sc.s_ior[si]
    if point_n is not None:
        take, ti = point_n
        tr = sc.tri
        tk = take[:, None]
        n = torch.where(tk, tr["normal"][ti], n)
        mat = torch.where(take, tr["mat"][ti], mat)
        alb = torch.where(tk, tr["albedo"][ti], alb)
        fz = torch.where(take, tr["fuzz"][ti], fz)
        io = torch.where(take, tr["ior"][ti], io)
    return is_hit, p, n, mat, alb, fz, io


def _camera_tensors(cams: List[dict], device, dtype):
    return {k: torch.as_tensor(np.stack([c[k] for c in cams]), device=device,
                               dtype=dtype) for k in cams[0]}


def render(scene: RefScene, cams: List[dict], width: int, height: int,
           spp: int, max_depth: int, seed: int,
           lanes_per_chunk: int = 1 << 21, stats: Optional[dict] = None
           ) -> np.ndarray:
    """u8 images [F, H, W, 3], one per camera.  ``stats``, when given,
    gets ``segments`` (rays traced, primary ones included) and ``primary``
    (primary rays)."""
    dev, dt = scene.device, scene.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    cam = _camera_tensors(cams, dev, dt)
    n_pix = len(cams) * height * width
    pix_per_chunk = max(1, lanes_per_chunk // spp)
    out = torch.empty((n_pix, 3), device=dev, dtype=torch.float32)
    segments = 0
    for p0 in range(0, n_pix, pix_per_chunk):
        p1 = min(n_pix, p0 + pix_per_chunk)
        lanes = (p1 - p0) * spp
        pix = p0 + torch.arange(lanes, device=dev) // spp
        frame = pix // (height * width)
        y = (pix // width) % height
        x = pix % width
        u = torch.rand((lanes, 5), generator=gen, device=dev).to(dt)
        uu = (x.to(dt) + u[:, 0]) / width
        vv = ((height - y).to(dt) + u[:, 1]) / height
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
        for _ in range(max_depth + 1):
            if live.numel() == 0:
                break
            segments += live.numel()
            is_hit, p, n, mat, alb, fz, io = hit(scene, o, d, time)
            miss = ~is_hit
            rad.index_add_(0, live[miss], thr[miss] * _sky(d[miss]))
            keep = is_hit
            live, o, d, time, thr = live[keep], o[keep], d[keep], time[keep], thr[keep]
            u = torch.rand((live.numel(), 4), generator=gen, device=dev).to(dt)
            o, d, att, alive = _scatter(d, p[keep], n[keep], mat[keep],
                                        alb[keep], fz[keep], io[keep], u)
            thr = thr * att
            live, o, d, time, thr = live[alive], o[alive], d[alive], time[alive], thr[alive]
        mean = rad.float().reshape(p1 - p0, spp, 3).sum(1) / spp
        out[p0:p1] = mean
    if stats is not None:
        stats["segments"] = stats.get("segments", 0) + segments
        stats["primary"] = stats.get("primary", 0) + n_pix * spp
    c = torch.sqrt(torch.clamp_min(out, 0.0))
    u8 = torch.clamp(torch.floor(255.99 * c), 0, 255).to(torch.uint8)
    return u8.reshape(len(cams), height, width, 3).cpu().numpy()
