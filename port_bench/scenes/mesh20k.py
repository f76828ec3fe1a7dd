"""BASELINE.json config 4 as the repo's benchmark builds it: a diffuse
ground, a diffuse and a glass hero sphere, a metal icosphere of five
subdivisions (20,480 triangles) and a glass box (12), 20,492 triangles."""

from __future__ import annotations

import numpy as np

from .common import DIELECTRIC, LAMBERTIAN, METAL, Spheres, triangle_arrays


def icosphere(center, radius, subdivisions):
    """Geodesic sphere: the icosahedron, each face split in four per level
    (children in order), vertices pushed to the sphere; f64 then f32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    verts = list(v)
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (verts[a] + verts[b]) / 2
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    v = np.asarray(center, np.float64) + np.asarray(verts) * radius
    return v.astype(np.float32), np.asarray(f, np.int64)


def box(center, size):
    """12-triangle axis-aligned box, faces wound outward."""
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) / 2
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    return c + corners * s, faces


def build() -> dict:
    s = Spheres()
    s.add((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    s.add((-2.5, 1.0, -1.0), 1.0, LAMBERTIAN, albedo=(0.4, 0.2, 0.1))
    s.add((2.5, 1.0, -1.0), 1.0, DIELECTRIC, ior=1.5)
    v1, f1 = icosphere((0.0, 1.0, 0.0), 1.0, 5)
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
