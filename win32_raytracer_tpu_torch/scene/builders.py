"""Canonical scenes, bit-identical to the reference's builders.

* :func:`test_scene`   — ``getTestScene`` (RayTracer.cpp:707-765)
* :func:`random_scene` — ``generateRandomScene`` (RayTracer.cpp:768-891),
  the RTIOW final scene, laid out with the reference's seed-666 LCG.
* :func:`mesh_scene`   — the composite demo of spheres and meshes
  (extension; BASELINE.json config 4).
"""

from __future__ import annotations

import numpy as np

from ..core import materials as mat
from ..core.rng import ReferenceLcg
from .composite import CompositeScene
from .spheres import LANE_PAD, SceneBuilder, SphereScene
from .triangles import box_mesh, build_triangle_scene, icosphere_mesh


def test_scene(pad_to: int = LANE_PAD, device="cpu") -> SphereScene:
    """6-sphere test scene; the two radius -0.5 spheres flip normals."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -100.5, 0.0), 100.0, (0.8, 0.8, 0.0))
    b.add_lambertian((0.0, 0.0, 0.0), -0.5, (0.1, 0.2, 0.5))
    b.add_metal((1.0, 0.0, 0.0), 0.5, (0.8, 0.6, 0.2), 0.0)
    b.add_dielectric((-1.0, 0.0, 0.0), -0.5, 1.5)
    b.add_lambertian((-2.0, 0.0, 0.0), 0.5, (0.6, 0.2, 0.5))
    b.add_lambertian((0.0, 0.0, -1.0), 0.5, (0.3, 0.7, 0.5))
    return b.build(pad_to, device)


def random_scene(seed: int = 666, pad_to: int = LANE_PAD,
                 device="cpu") -> SphereScene:
    """Ground sphere r=1000, three hero spheres and a 22x22 jittered grid
    (80% moving lambertian / 15% metal / 5% dielectric)."""
    world_length = 22
    radius = 0.2
    pos_randomness = 0.9
    spacing = 1.0

    lcg = ReferenceLcg(seed)
    b = SceneBuilder()

    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.add_dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)

    half = world_length // 2
    for a in range(-half, half):
        for c in range(-half, half):
            r = lcg.rand4()
            center = (a * spacing + pos_randomness * float(r[0]),
                      radius,
                      c * spacing + pos_randomness * float(r[1]))
            choice = float(r[2])
            if choice < 0.8:  # lambertian (moving)
                r = lcg.rand4()
                color = (float(r[0] * r[1]), float(r[1] * r[2]), float(r[2] * r[3]))
                b.add_moving(center,
                             (center[0], center[1] + 3.0, center[2]),
                             0.0, 1.0, radius, mat.LAMBERTIAN, albedo=color)
            elif choice < 0.95:  # metal
                r = lcg.rand4()
                fuzz = 0.5 * float(r[0])
                color = (0.5 * (1.0 + float(r[1])),
                         0.5 * (1.0 + float(r[2])),
                         0.5 * (1.0 + float(r[3])))
                b.add_metal(center, radius, color, fuzz)
            else:  # dielectric
                b.add_dielectric(center, radius, 1.5)

    return b.build(pad_to, device)


def mesh_scene(pad_to: int = LANE_PAD, subdivisions: int = 2,
               device="cpu") -> CompositeScene:
    """Diffuse ground and two hero spheres plus a metal icosphere mesh and a
    glass box mesh.  ``subdivisions`` sets the icosphere's density: 2 ->
    320 triangles (332 with the box: the brute sweep), 5 -> 20480 (the
    Morton-tile grid, tri_accel.py)."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.add_lambertian((-2.5, 1.0, -1.0), 1.0, (0.4, 0.2, 0.1))
    b.add_dielectric((2.5, 1.0, -1.0), 1.0, 1.5)
    spheres = b.build(pad_to, device)

    v1, f1 = icosphere_mesh((0.0, 1.0, 0.0), 1.0, subdivisions=subdivisions)
    v2, f2 = box_mesh((0.0, 0.35, 2.2), (0.7, 0.7, 0.7))
    verts = np.concatenate([v1, v2], axis=0)
    faces = np.concatenate([f1, f2 + len(v1)], axis=0)
    mats = np.concatenate([np.full(len(f1), mat.METAL, np.int32),
                           np.full(len(f2), mat.DIELECTRIC, np.int32)])
    albs = np.concatenate([np.tile([0.8, 0.7, 0.6], (len(f1), 1)),
                           np.tile([1.0, 1.0, 1.0], (len(f2), 1))]).astype(np.float32)
    tris = build_triangle_scene(verts, faces, mat_id=mats, albedo=albs,
                                fuzz=0.05, ior=1.5, pad_to=pad_to,
                                device=device)
    return CompositeScene(spheres=spheres, triangles=tris)


SCENES = {
    "test": test_scene,
    "random": random_scene,
    "final": random_scene,  # alias: RTIOW "final scene"
    "mesh": mesh_scene,
    # 20480-triangle icosphere + glass box + spheres: BASELINE config 4.
    "mesh20k": lambda pad_to=LANE_PAD, device="cpu": mesh_scene(
        pad_to, subdivisions=5, device=device),
}


def get_scene(name: str, **kw):
    try:
        builder = SCENES[name]
    except KeyError:
        raise ValueError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return builder(**kw)
