"""The port's ``mesh`` scene (its ``mesh_scene`` at the default two
subdivisions; ``--scene mesh``): ``mesh20k.py``'s layout with a metal
icosphere of 320 triangles and the glass box (12), 332 triangles, and the
same 3 spheres.  Below the port's 512-triangle grid threshold, so the port
sweeps it by brute force."""

from __future__ import annotations

import numpy as np

from .common import DIELECTRIC, LAMBERTIAN, METAL, Spheres, triangle_arrays
from .mesh20k import box, icosphere


def build() -> dict:
    s = Spheres()
    s.add((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    s.add((-2.5, 1.0, -1.0), 1.0, LAMBERTIAN, albedo=(0.4, 0.2, 0.1))
    s.add((2.5, 1.0, -1.0), 1.0, DIELECTRIC, ior=1.5)
    v1, f1 = icosphere((0.0, 1.0, 0.0), 1.0, 2)
    v2, f2 = box((0.0, 0.35, 2.2), (0.7, 0.7, 0.7))
    verts = np.concatenate([v1, v2])
    faces = np.concatenate([f1, f2 + len(v1)])
    mats = np.concatenate([np.full(len(f1), METAL, np.int32),
                           np.full(len(f2), DIELECTRIC, np.int32)])
    albedo = np.concatenate([np.tile([0.8, 0.7, 0.6], (len(f1), 1)),
                             np.tile([1.0, 1.0, 1.0], (len(f2), 1))])
    tris = triangle_arrays(verts, faces, mats, albedo.astype(np.float32),
                           fuzz=0.05, ior=1.5)
    return {"spheres": s.arrays(), "triangles": tris}
