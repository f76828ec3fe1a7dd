"""SoA triangle-mesh scene as a container of tensors.

Same layout as ``win32_raytracer_tpu.scene.triangles``: triangles are
stored as (v0, e1 = v1 - v0, e2 = v2 - v0), so the Moller-Trumbore test
needs no per-pair vertex math, and padded to a multiple of ``LANE_PAD`` with
inactive entries parked far below the scene.  Materials reuse the sphere
material model (RayTracer.cpp:93-117).  Meshes are an extension of the
sphere-only reference (BASELINE.json config 4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import materials as mat
from .spheres import LANE_PAD


class TriangleScene(NamedTuple):
    v0: torch.Tensor       # [T, 3] f32
    e1: torch.Tensor       # [T, 3] f32 (v1 - v0)
    e2: torch.Tensor       # [T, 3] f32 (v2 - v0)
    mat_id: torch.Tensor   # [T] int32
    albedo: torch.Tensor   # [T, 3] f32
    fuzz: torch.Tensor     # [T] f32
    ior: torch.Tensor      # [T] f32
    active: torch.Tensor   # [T] bool

    @property
    def padded_size(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def to(self, device) -> "TriangleScene":
        return TriangleScene(*(x.to(device) for x in self))


_DTYPES = (torch.float32,) * 3 + (torch.int32,) + (torch.float32,) * 3 + (
    torch.bool,)


def triangles_from_numpy(src, device="cpu") -> TriangleScene:
    """Port scene from any object carrying the ``TriangleScene`` fields as
    arrays (e.g. the JAX package's)."""
    return TriangleScene(*(
        torch.as_tensor(np.array(getattr(src, f)), dtype=dt, device=device)
        for f, dt in zip(TriangleScene._fields, _DTYPES)))


def build_triangle_scene(vertices: np.ndarray, faces: np.ndarray,
                         mat_id=mat.LAMBERTIAN, albedo=(0.73, 0.73, 0.73),
                         fuzz=0.0, ior=1.5, pad_to: int = LANE_PAD,
                         device="cpu") -> TriangleScene:
    """One mesh, one material (per-face arrays also accepted)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    f = len(faces)
    if f == 0:
        raise ValueError("empty mesh")
    padded = max(pad_to, -(-f // pad_to) * pad_to)

    v0 = np.zeros((padded, 3), np.float32)
    e1 = np.zeros((padded, 3), np.float32)
    e2 = np.zeros((padded, 3), np.float32)
    v0[f:] = (0.0, -1.0e8, 0.0)  # park padding

    tri = vertices[faces]                     # [F, 3, 3]
    v0[:f] = tri[:, 0]
    e1[:f] = tri[:, 1] - tri[:, 0]
    e2[:f] = tri[:, 2] - tri[:, 0]

    def per_face(x, width=None):
        shape = (padded, width) if width else (padded,)
        out = np.zeros(shape, np.float32)
        out[:f] = np.broadcast_to(np.asarray(x, np.float32), (f,) + shape[1:])
        return out

    mid = np.zeros((padded,), np.int32)
    mid[:f] = np.broadcast_to(np.asarray(mat_id, np.int32), (f,))
    act = np.zeros((padded,), bool)
    act[:f] = True
    ior_col = np.where(act, per_face(ior), 1.0).astype(np.float32)
    return TriangleScene(*(torch.from_numpy(x).to(device) for x in (
        v0, e1, e2, mid, per_face(albedo, 3), per_face(fuzz), ior_col, act)))


# ---------------------------------------------------------------------------
# Procedural meshes + OBJ IO
# ---------------------------------------------------------------------------


def box_mesh(center=(0, 0, 0), size=(1, 1, 1)):
    """12-triangle axis-aligned box; returns (vertices, faces)."""
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) / 2
    corners = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        np.float32)
    v = c + corners * s
    # Outward-wound faces (CCW seen from outside).
    faces = np.array([
        [0, 1, 3], [0, 3, 2],  # -x
        [4, 6, 7], [4, 7, 5],  # +x
        [0, 4, 5], [0, 5, 1],  # -y
        [2, 3, 7], [2, 7, 6],  # +y
        [0, 2, 6], [0, 6, 4],  # -z
        [1, 5, 7], [1, 7, 3],  # +z
    ], np.int64)
    return v, faces


def icosphere_mesh(center=(0, 0, 0), radius=1.0, subdivisions=2):
    """Geodesic sphere; returns (vertices, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)

    for _ in range(subdivisions):
        cache = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (verts[a] + verts[b]) / 2
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)

    v = np.asarray(center, np.float64) + v * radius
    return v.astype(np.float32), f


def load_obj(path: str):
    """Minimal wavefront OBJ loader (v / f records, fans triangulated);
    returns (vertices [V,3] f32, faces [F,3] int64)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not faces:
        raise ValueError(f"no faces in {path}")
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)
