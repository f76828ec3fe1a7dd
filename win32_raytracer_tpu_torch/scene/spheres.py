"""SoA sphere scene as a container of tensors.

Same layout as ``win32_raytracer_tpu.scene.spheres``: sphere counts are
padded to a multiple of ``LANE_PAD`` with inactive entries (fixing the
reference's ``size % 8`` dropout, RayTracer.cpp:432-434), and negative
radii flip the normal (the hollow-glass trick, RayTracer.cpp:531-533).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import materials as mat

LANE_PAD = 128  # pad the sphere count to a multiple of this


class SphereScene(NamedTuple):
    """Motion-blur spheres lerp ``center1 -> center2`` over ``[t1, t2]``
    (RayTracer.cpp:449-452); static spheres use t1=0, t2=1, c1 == c2."""

    center1: torch.Tensor   # [S, 3] f32, position at t1
    center2: torch.Tensor   # [S, 3] f32, position at t2
    t1: torch.Tensor        # [S] f32
    t2: torch.Tensor        # [S] f32
    radius: torch.Tensor    # [S] f32 (signed)
    mat_id: torch.Tensor    # [S] int32
    albedo: torch.Tensor    # [S, 3] f32
    fuzz: torch.Tensor      # [S] f32
    ior: torch.Tensor       # [S] f32
    active: torch.Tensor    # [S] bool — False for padding

    @property
    def padded_size(self) -> int:
        return self.radius.shape[0]

    @property
    def device(self) -> torch.device:
        return self.radius.device

    def to(self, device) -> "SphereScene":
        return SphereScene(*(x.to(device) for x in self))


_DTYPES = (torch.float32,) * 5 + (torch.int32,) + (torch.float32,) * 3 + (
    torch.bool,)


def scene_from_numpy(src, device="cpu"):
    """Port scene from any object carrying the fields of a ``SphereScene``,
    a ``TriangleScene`` (scene/triangles.py) or a ``CompositeScene``
    (scene/composite.py) as arrays, e.g. the JAX package's scene; each
    field goes through ``np.array``, which copies."""
    if hasattr(src, "triangles"):
        from .composite import CompositeScene
        return CompositeScene(*(None if x is None
                                else scene_from_numpy(x, device)
                                for x in (src.spheres, src.triangles)))
    if hasattr(src, "e1"):
        from .triangles import triangles_from_numpy
        return triangles_from_numpy(src, device)
    return SphereScene(*(
        torch.as_tensor(np.array(getattr(src, f)), dtype=dt, device=device)
        for f, dt in zip(SphereScene._fields, _DTYPES)))


class SceneBuilder:
    """Host-side accumulation mirroring ``Spheres::add/addMoving``
    (RayTracer.cpp:310-361), finalized into a padded :class:`SphereScene`."""

    def __init__(self):
        self._rows = []  # (c1, c2, t1, t2, radius, mat_id, albedo, fuzz, ior)

    def add(self, center, radius, mat_id, albedo=(0.0, 0.0, 0.0), fuzz=0.0,
            ior=1.0):
        """Static sphere: center2 = center1, t in [0, 1]."""
        c = tuple(float(v) for v in center)
        self._rows.append((c, c, 0.0, 1.0, float(radius), int(mat_id),
                           tuple(float(v) for v in albedo), float(fuzz),
                           float(ior)))
        return self

    def add_moving(self, center1, center2, t1, t2, radius, mat_id,
                   albedo=(0.0, 0.0, 0.0), fuzz=0.0, ior=1.0):
        """Moving sphere (RayTracer.cpp:333-361); t1 != t2 required."""
        if t1 == t2:
            raise ValueError("moving sphere requires t1 != t2 (RayTracer.cpp:346)")
        self._rows.append((tuple(float(v) for v in center1),
                           tuple(float(v) for v in center2),
                           float(t1), float(t2), float(radius), int(mat_id),
                           tuple(float(v) for v in albedo), float(fuzz),
                           float(ior)))
        return self

    def add_lambertian(self, center, radius, albedo):
        return self.add(center, radius, mat.LAMBERTIAN, albedo=albedo)

    def add_metal(self, center, radius, albedo, fuzz):
        return self.add(center, radius, mat.METAL, albedo=albedo, fuzz=fuzz)

    def add_dielectric(self, center, radius, ior):
        return self.add(center, radius, mat.DIELECTRIC, ior=ior)

    def __len__(self):
        return len(self._rows)

    def build(self, pad_to: int = LANE_PAD, device="cpu") -> SphereScene:
        n = len(self._rows)
        if n == 0:
            raise ValueError("empty scene")
        padded = max(pad_to, -(-n // pad_to) * pad_to)

        c1 = np.zeros((padded, 3), np.float32)
        c2 = np.zeros((padded, 3), np.float32)
        t1 = np.zeros((padded,), np.float32)
        t2 = np.ones((padded,), np.float32)   # no 0/0 in the lerp on pads
        rad = np.zeros((padded,), np.float32)
        mid = np.zeros((padded,), np.int32)
        alb = np.zeros((padded, 3), np.float32)
        fz = np.zeros((padded,), np.float32)
        ior = np.ones((padded,), np.float32)
        act = np.zeros((padded,), bool)

        for i, (a, b, ta, tb, r, m, al, f, io) in enumerate(self._rows):
            c1[i], c2[i], t1[i], t2[i], rad[i] = a, b, ta, tb, r
            mid[i], alb[i], fz[i], ior[i], act[i] = m, al, f, io, True

        # Park padding far away so even a radius-0 test can't hit.
        c1[n:] = c2[n:] = (0.0, -1.0e8, 0.0)

        return SphereScene(*(torch.from_numpy(x).to(device) for x in
                             (c1, c2, t1, t2, rad, mid, alb, fz, ior, act)))
