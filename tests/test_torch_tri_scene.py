"""PyTorch port: triangle scenes, mesh builders and the Morton-tile grid
build against the JAX package."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu import tri_accel as jacc
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu.scene import triangles as jtri
from win32_raytracer_tpu_torch import tri_accel as tacc
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene import triangles as ttri
from win32_raytracer_tpu_torch.scene.composite import CompositeScene
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

torch.set_num_threads(1)


def _assert_equal(ours, ref):
    """Field by field, dtype and values, of two NamedTuples (None allowed)."""
    if ref is None:
        assert ours is None
        return
    for f in ref._fields:
        a, b = getattr(ours, f), getattr(ref, f)
        if hasattr(b, "_fields"):
            _assert_equal(a, b)
            continue
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _mesh(mod, subdiv=3):
    """tests/test_tri_grid.py's mesh: an icosphere and a box."""
    v1, f1 = mod.icosphere_mesh((0.0, 1.0, 0.0), 1.0, subdivisions=subdiv)
    v2, f2 = mod.box_mesh((2.0, 0.4, 0.5), (0.8, 0.8, 0.8))
    verts = np.concatenate([v1, v2], axis=0)
    faces = np.concatenate([f1, f2 + len(v1)], axis=0)
    return mod.build_triangle_scene(verts, faces)


@pytest.mark.parametrize("subdiv", [0, 2, 3])
def test_procedural_meshes_array_equal(subdiv):
    for ours, ref in zip(ttri.icosphere_mesh((0.5, 1.0, -2.0), 1.5, subdiv),
                         jtri.icosphere_mesh((0.5, 1.0, -2.0), 1.5, subdiv)):
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(ttri.box_mesh((1, 2, 3), (0.5, 1, 2)),
                         jtri.box_mesh((1, 2, 3), (0.5, 1, 2))):
        np.testing.assert_array_equal(ours, ref)
    _assert_equal(_mesh(ttri, subdiv), _mesh(jtri, subdiv))


def test_per_face_materials_and_padding():
    v, f = ttri.box_mesh()
    kw = dict(mat_id=np.arange(12) % 3, albedo=np.linspace(0, 1, 36).reshape(12, 3),
              fuzz=0.25, ior=1.33, pad_to=8)
    ours = ttri.build_triangle_scene(v, f, **kw)
    _assert_equal(ours, jtri.build_triangle_scene(v, f, **kw))
    assert ours.padded_size == 16 and int(ours.active.sum()) == 12
    with pytest.raises(ValueError, match="empty"):
        ttri.build_triangle_scene(v, f[:0])


@pytest.mark.parametrize("subdivisions", [2, 3])
def test_mesh_scene_array_equal(subdivisions):
    ours = tb.mesh_scene(subdivisions=subdivisions)
    ref = jb.mesh_scene(subdivisions=subdivisions)
    assert isinstance(ours, CompositeScene)
    _assert_equal(ours, ref)
    assert ours.padded_size == ref.padded_size
    _assert_equal(scene_from_numpy(ref), ref)


def test_mesh_scene_names():
    mesh = tb.get_scene("mesh")
    assert int(mesh.triangles.active.sum()) == 332
    assert mesh.spheres.padded_size == 128
    assert tb.get_scene("mesh20k").triangles.padded_size == 20608


def test_load_obj_round_trip(tmp_path):
    """Fans triangulate, negative (relative) indices resolve, and a mesh
    written as OBJ reads back as the same triangles in both packages."""
    v, f = ttri.icosphere_mesh(subdivisions=1)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1}/7 {c + 1}//2" for a, b, c in f]
    lines += ["f 1 2 3 4", "f -1 -2 -3", "# comment", ""]
    path = tmp_path / "mesh.obj"
    path.write_text("\n".join(lines))
    ours, ref = ttri.load_obj(str(path)), jtri.load_obj(str(path))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[0], v)
    np.testing.assert_array_equal(ours[1][:len(f)], f)
    np.testing.assert_array_equal(ours[1][len(f):],
                                  [[0, 1, 2], [0, 2, 3], [41, 40, 39]])
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\n")
    with pytest.raises(ValueError, match="no faces"):
        ttri.load_obj(str(empty))


@pytest.mark.parametrize("partition", ["morton", "median"])
@pytest.mark.parametrize("tile_rows", [64, 128])
def test_build_tri_grid_array_equal(partition, tile_rows):
    ref = jacc.build_tri_grid(_mesh(jtri), tile_rows=tile_rows,
                              partition=partition)
    ours = tacc.build_tri_grid(_mesh(ttri), tile_rows=tile_rows,
                               partition=partition)
    for f in ("tile_attrs", "tile_boxes", "scene_box"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (ours.n_tiles, ours.tile_rows) == (ref.n_tiles, tile_rows)
    back = tacc.tri_grid_from_numpy(ref)
    for a, b in zip(back[1:], ours[1:]):
        assert torch.equal(a, b)
    _assert_equal(back.base, ref.base)


def test_build_tri_grid_declines_and_memoises():
    small = _mesh(ttri, 1)            # 92 triangles, below min_tris
    assert tacc.build_tri_grid(small) is None
    assert jacc.build_tri_grid(_mesh(jtri, 1)) is None
    scene = _mesh(ttri)
    g1 = tacc.build_tri_grid(scene)
    assert tacc.build_tri_grid(scene) is g1
    assert tacc.build_tri_grid(scene, tile_rows=64) is not g1
    with pytest.raises(ValueError, match="partition"):
        tacc.build_tri_grid(scene, partition="kd")
