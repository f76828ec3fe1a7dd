"""PyTorch port: the triangle knobs (what runs, what raises and why) and
the device rule of the entry points."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu_torch import api
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.kernels import dispatch as D
from win32_raytracer_tpu_torch.persistent import check_supported
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.tri_accel import TriGridScene

torch.set_num_threads(1)


@pytest.mark.parametrize("knob,item", [
    (dict(tri_sub_gate=2), "tri_sub_gate"),
    (dict(tri_sub_gate=16), "tri_sub_gate"),
    (dict(tri_rebin="on"), "tri_rebin"),
    (dict(tri_rebin="dda"), "tri_rebin"),
    (dict(tri_dda_k=4), "tri_dda"),
])
def test_unported_tri_knobs_raise(knob, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item 9 .*{item}"):
        check_supported(RenderConfig(**knob), tb.mesh_scene())


@pytest.mark.parametrize("knob,match", [
    (dict(tri_rebin="sometimes"), "tri_rebin"),
    (dict(tri_any_skip="yes"), "tri_any_skip"),
    (dict(tri_dda_k=-1), "tri_dda_k"),
    (dict(tri_sub_gate=3), "tri_sub_gate"),
    (dict(tri_gather="onehot"), "tri_gather"),
    (dict(tri_tile_rows=-8), "tri_tile_rows"),
])
def test_invalid_tri_knobs_raise_the_reference_errors(knob, match):
    with pytest.raises(ValueError, match=match):
        check_supported(RenderConfig(**knob), tb.mesh_scene())


@pytest.mark.parametrize("knob", [
    dict(accel="grid"), dict(ray_binning="on"), dict(ray_binning="off"),
    dict(tri_tile_rows=64), dict(tri_ray_block=512),
    dict(tri_partition="median"), dict(tri_early_exit="off"),
    dict(tri_any_skip="off"), dict(tri_gather="deferred"),
    dict(tri_gather="fused"), dict(tri_rebin="off"),
])
def test_ported_tri_knobs_resolve(knob):
    """Each ported knob passes the check and reaches the grid route."""
    scene = tb.mesh_scene(subdivisions=3)
    cfg = RenderConfig(**knob)
    check_supported(cfg, scene)
    hit_scene, hit_fn = D.get_hit_fn_rows_accel(cfg, scene)
    grid = hit_scene.triangles
    assert isinstance(grid, TriGridScene)
    assert grid.tile_rows == (cfg.tri_tile_rows or 128)
    o = torch.tensor([[0.0], [1.0], [-5.0]])
    d = torch.tensor([[0.0], [0.0], [1.0]])
    rec = hit_fn(hit_scene, o, d, torch.zeros(1, 1))
    assert rec.hit.item() and abs(rec.t.item() - 4.0) < 1e-2
    assert rec.idx.item() >= 128            # a triangle, after the spheres


def test_accel_routes():
    """Brute below min_tris and under accel="off"; the grid otherwise;
    accel="grid" raises the reference's ValueError where no grid can be
    built, for a mesh and for a sphere scene too small for the sphere
    grid."""
    assert not isinstance(D.get_hit_fn_rows_accel(
        RenderConfig(), tb.mesh_scene())[0].triangles, TriGridScene)
    assert not isinstance(D.get_hit_fn_rows_accel(
        RenderConfig(accel="off"), tb.mesh_scene(subdivisions=3))[0].triangles,
        TriGridScene)
    with pytest.raises(ValueError, match="does not qualify"):
        D.get_hit_fn_rows_accel(RenderConfig(accel="grid"), tb.mesh_scene())
    check_supported(RenderConfig(accel="grid"), tb.get_scene("test"))
    with pytest.raises(ValueError, match="does not qualify"):
        D.get_hit_fn_rows_accel(RenderConfig(accel="grid"),
                                tb.get_scene("test"))


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_cuda_device_resolves_to_triangle_kernel_wrappers(backend):
    """Without the grid a triangle scene gets kernel C's wrapper on a CUDA
    device; only an explicit backend="jnp" reaches its plain version."""
    from win32_raytracer_tpu_torch.kernels import tri as KC
    tris = tb.mesh_scene().triangles
    assert D.get_hit_fn_rows(RenderConfig(backend=backend), "cuda",
                             tris) is KC.hit_triangles_rows
    assert D.get_hit_fn_rows(RenderConfig(backend="jnp"), "cuda",
                             tris) is KC.hit_triangles_rows_plain


def test_brute_composite_matches_the_accel_route():
    """get_hit_fn_rows' brute composite reads the scene as it is and gives
    the records of get_hit_fn_rows_accel's brute route on its tables."""
    scene = tb.mesh_scene()
    rng = np.random.default_rng(3)
    n = 512
    o = torch.from_numpy(np.ascontiguousarray(
        rng.uniform([-3, 0.2, -2], [3, 3, 4], (n, 3)).T, np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    tm = torch.zeros(1, n)
    ours = D.get_hit_fn_rows(RenderConfig(), "cpu", scene)(scene, o, d, tm)
    hit_scene, fn = D.get_hit_fn_rows_accel(RenderConfig(), scene)
    ref = fn(hit_scene, o, d, tm)
    assert ours.hit.any() and (ours.idx[ours.hit] >= 128).any()
    for f in ours._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      getattr(ref, f).numpy(), err_msg=f)


def test_no_card_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=16, height=8, samples=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.render("test", cfg=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.render_async("test", cfg=cfg)
    res = api.render("test", cfg=cfg, device="cpu")
    assert res.device == "cpu" and res.image.shape == (8, 16, 3)
    handle = api.render_async("test", cfg=cfg, device="cpu")
    assert handle.join(timeout=300).image.shape == (8, 16, 3)
    assert api.resolve_device("cpu") == torch.device("cpu")


def test_mesh_render_on_cpu_runs():
    """render("mesh") and the triangle-only scene run end to end."""
    cfg = RenderConfig(width=16, height=8, samples=8, seed=3)
    res = api.render("mesh", cfg=cfg, device="cpu")
    assert res.image.shape == (8, 16, 3) and 0 < res.image.mean() < 255
    tris = tb.mesh_scene().triangles
    img = api.render(tris, cfg=cfg, device="cpu").image
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
