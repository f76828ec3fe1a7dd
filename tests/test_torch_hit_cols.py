"""PyTorch port: the wavefront scheduler's column hit functions (kernels G
and H's plain versions, ``combine_hits``, ``make_hit_fn`` and
``get_hit_fn``) against the JAX package's column sweeps and its Pallas
kernels ``_hit_kernel_v3`` and ``_tri_kernel`` in interpret mode.

Kernels G and H themselves (CUDA) are held against these plain sweeps on
the card by chip_smoke.py phase 13.

Tolerances.  Hit masks and winners agree on >= 99.9% of the rays (spheres)
or everywhere but within 1e-6 of a triangle edge (triangles, at most 1e-4
of the rays).  t is held to the float64 root within 4 f32 epsilons of the
formula's scale, in both packages, since XLA's CPU code fuses multiplies
and adds where torch rounds each, and the r=1000 ground sphere's root is
ill conditioned.  The Pallas kernels return the attributes of row 0 on a
miss (a one-hot of index 0), the port zeros, so attributes are compared on
hit lanes only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu.kernels.hit_pallas_v3 import hit_spheres_pallas_v3
from win32_raytracer_tpu.kernels.tri_pallas import hit_triangles_pallas
from win32_raytracer_tpu.ops.hit import HitRecord as JRec
from win32_raytracer_tpu.ops.hit import hit_spheres as jax_hit_spheres
from win32_raytracer_tpu.ops.hit_tri import combine_hits as jax_combine
from win32_raytracer_tpu.ops.hit_tri import hit_triangles as jax_hit_tri
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu.scene.composite import make_hit_fn as jax_make_hit_fn
from win32_raytracer_tpu_torch.config import RenderConfig
from win32_raytracer_tpu_torch.kernels import hit_cols as G
from win32_raytracer_tpu_torch.kernels import tri_cols as H
from win32_raytracer_tpu_torch.kernels.dispatch import get_hit_fn, hit_tables
from win32_raytracer_tpu_torch.ops.hit import HitRecord, hit_spheres
from win32_raytracer_tpu_torch.ops.hit_tri import combine_hits, hit_triangles
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene.composite import CompositeScene, make_hit_fn

torch.set_num_threads(1)

EPS = 2.0 ** -24


def _sphere_rays(n, seed):
    """Rays [N, 3] above the ground, from the camera region and from
    inside the big glass sphere; shutter times over the motion interval."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-11, 0.01, -11], [11, 3, 11], (n, 3))
    o[: n // 4] = np.array([15.0, 2.0, 4.0]) + rng.normal(0, 0.3, (n // 4, 3))
    o[n // 4: n // 4 + 16] = [0.0, 1.0, 0.0]
    d = rng.normal(0, 1, (n, 3))
    t = rng.uniform(0, 1, n)
    return o.astype(np.float32), d.astype(np.float32), t.astype(np.float32)


def _tri_rays(n, seed):
    """Rays [N, 3] from around the mesh scene toward its meshes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.0, 0.0, -2.0], [3.0, 3.0, 4.0], (n, 3))
    tgt = np.where(rng.uniform(size=(n, 1)) < 0.8,
                   [0.0, 1.0, 0.0] + rng.normal(0, 0.7, (n, 3)),
                   [0.0, 0.35, 2.2] + rng.normal(0, 0.4, (n, 3)))
    d = tgt - o + rng.normal(0, 0.05, (n, 3))
    return o.astype(np.float32), d.astype(np.float32), np.zeros(n, np.float32)


def _np(rec):
    return {f: np.asarray(getattr(rec, f)) for f in HitRecord._fields}


def _sphere_root(o, d, t, scene, idx):
    """The winning sphere's near root in float64 and the scale of the
    terms an f32 evaluation rounds (tests/test_torch_hit.py)."""
    c1 = np.asarray(scene.center1, np.float64)
    dc = np.asarray(scene.center2, np.float64) - c1
    t1 = np.asarray(scene.t1, np.float64)
    inv_dt = 1.0 / (np.asarray(scene.t2, np.float64) - t1)
    r = np.asarray(scene.radius, np.float64)[idx]
    lerp = (t.astype(np.float64) - t1[idx]) * inv_dt[idx]
    oc = o.astype(np.float64) - (c1[idx] + dc[idx] * lerp[:, None])
    dd = d.astype(np.float64)
    a = (dd * dd).sum(1)
    b = (dd * oc).sum(1)
    oc2 = (oc * oc).sum(1)
    sq = np.sqrt(np.maximum(b * b - a * (oc2 - r * r), 0.0))
    scale = (np.abs(b) + (b * b + a * oc2 + a * r * r) / np.maximum(sq, 1e-30)) / a
    return (-b - sq) / a, scale


def _hold_spheres(ours, ref, o, d, t, jscene, min_agree=0.999):
    """Winners agree on >= min_agree of the rays; on agreeing hits t within
    4 f32 epsilons of the float64 root (both), point and normal within
    rtol 1e-5 plus that bound, the material exactly."""
    a, b = _np(ours), _np(ref)
    assert (a["hit"] == b["hit"]).mean() >= min_agree
    agree = a["hit"] & b["hit"] & (a["idx"] == b["idx"])
    assert agree.mean() >= min_agree * a["hit"].mean()
    root, scale = _sphere_root(o, d, t, jscene, a["idx"])
    bound = 4 * EPS * scale
    for got in (a["t"], b["t"]):
        assert (np.abs(got - root) <= bound)[agree].all()
    dlen = np.linalg.norm(d, axis=1)
    radius = np.abs(np.asarray(jscene.radius))[a["idx"]]
    for f, extra in (("point", 2 * bound * dlen), ("normal", 2 * bound * dlen / radius)):
        tol = 1e-5 * np.abs(b[f]) + 1e-6 + extra[:, None]
        assert (np.abs(a[f] - b[f]) <= tol)[agree].all(), f
    for f in ("albedo", "fuzz", "ior", "mat_id"):
        np.testing.assert_array_equal(a[f][agree], b[f][agree], err_msg=f)
    return agree


def _mt_f64(o, d, v0, e1, e2):
    """float64 Moller-Trumbore, one triangle per ray: (t, u, v, scale)."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    p = np.cross(d, e2)
    det = (e1 * p).sum(1)
    tv = o - v0
    q = np.cross(tv, e1)
    t = (e2 * q).sum(1) / det
    nrm = np.linalg.norm
    e12 = nrm(e1, axis=1) * nrm(e2, axis=1)
    scale = (e12 * nrm(tv, axis=1) + np.abs(t) * e12 * nrm(d, axis=1)) / np.abs(det)
    return t, (tv * p).sum(1) / det, (d * q).sum(1) / det, scale


def _hold_tris(ours, ref, o, d, jtris):
    """tests/test_torch_tri_hit.py's tolerances, column layout."""
    a, b = _np(ours), _np(ref)
    tris = tuple(np.asarray(getattr(jtris, f), np.float64) for f in ("v0", "e1", "e2"))
    bad = (a["hit"] != b["hit"]) | (a["hit"] & b["hit"] & (a["idx"] != b["idx"]))
    for idx, sel in ((a["idx"], bad & a["hit"]), (b["idx"], bad & b["hit"])):
        if sel.any():
            _, u, v, _ = _mt_f64(o[sel], d[sel], *(x[idx[sel]] for x in tris))
            edge = np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(1 - u - v))
            assert (edge < 1e-6).all(), edge
    assert bad.mean() <= 1e-4, bad.sum()
    agree = a["hit"] & b["hit"] & (a["idx"] == b["idx"])
    t64, _, _, s = _mt_f64(o, d, *(x[a["idx"]] for x in tris))
    for got in (a["t"], b["t"]):
        assert (np.abs(got - t64) <= 4 * EPS * s)[agree].all()
    dlen = np.linalg.norm(d, axis=1)
    sp = np.linalg.norm(o, axis=1) + np.abs(t64) * dlen + s * dlen
    assert (np.abs(a["point"] - b["point"]) <= 8 * EPS * sp[:, None])[agree].all()
    assert (np.abs(a["normal"] - b["normal"]) <= 8 * EPS)[agree].all()
    for f in ("mat_id", "albedo", "fuzz", "ior"):
        np.testing.assert_array_equal(a[f][agree], b[f][agree], err_msg=f)
    return agree


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def test_plain_sphere_cols_matches_reference_sweep():
    o, d, t = _sphere_rays(4096, seed=0)
    js = jb.random_scene()
    ours = hit_spheres(tb.random_scene(), *_t(o, d, t))
    ref = jax_hit_spheres(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    agree = _hold_spheres(ours, ref, o, d, t, js)
    assert 0.2 < agree.mean() < 0.95
    # The record's misses are all zero (idx 0), as the reference's.
    miss = ~ours.hit.numpy()
    assert not ours.idx.numpy()[miss].any() and not ours.albedo.numpy()[miss].any()


def test_plain_sphere_cols_matches_v3_kernel_interpret():
    """Against ``_hit_kernel_v3`` (interpret mode, ray block 128).  v3
    gates spheres by r != 0 and has no active input; the port gates by the
    active mask.  The scene's padding rows are exactly the r = 0 rows and
    the inactive ones, so the two gates agree here."""
    o, d, t = _sphere_rays(512, seed=1)
    js = jb.random_scene()
    ts = tb.random_scene()
    pad = ~ts.active.numpy()
    assert pad.sum() == 512 - 488
    np.testing.assert_array_equal(ts.radius.numpy() == 0.0, pad)
    ours = hit_spheres(ts, *_t(o, d, t))
    ref = hit_spheres_pallas_v3(js, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t), ray_block=128, interpret=True)
    _hold_spheres(ours, ref, o, d, t, js)


def test_plain_tri_cols_matches_reference_sweep():
    o, d, t = _tri_rays(4096, seed=2)
    jt = jb.mesh_scene().triangles
    ours = hit_triangles(tb.mesh_scene().triangles, *_t(o, d, t))
    ref = jax_hit_tri(jt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    agree = _hold_tris(ours, ref, o, d, jt)
    assert 0.5 < agree.mean() < 0.95
    miss = ~ours.hit.numpy()
    assert not ours.normal.numpy()[miss].any() and not ours.idx.numpy()[miss].any()


def test_plain_tri_cols_matches_tri_kernel_interpret():
    """Against ``_tri_kernel`` (interpret mode), which rejects its padding
    rows by det ~ 0 where the port masks them inactive."""
    o, d, t = _tri_rays(512, seed=3)
    jt = jb.mesh_scene().triangles
    ours = hit_triangles(tb.mesh_scene().triangles, *_t(o, d, t))
    ref = hit_triangles_pallas(jt, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t), ray_block=256, interpret=True)
    _hold_tris(ours, ref, o, d, jt)


def test_wrappers_on_cpu_are_the_plain_sweeps():
    o, d, t = _t(*_sphere_rays(300, seed=4))
    tab = hit_tables(tb.random_scene())
    before = (G.LAUNCHES, H.LAUNCHES)
    for x, y in zip(G.hit_spheres_cols(tab, o, d, t), hit_spheres(tab, o, d, t)):
        assert torch.equal(x, y)
    o, d, t = _t(*_tri_rays(300, seed=5))
    tris = hit_tables(tb.mesh_scene().triangles)
    for x, y in zip(H.hit_triangles_cols(tris, o, d, t),
                    hit_triangles(tris, o, d, t)):
        assert torch.equal(x, y)
    assert (G.LAUNCHES, H.LAUNCHES) == before   # nothing launched for CPU tensors
    meta = [x.to("meta") for x in (o, d, t)]
    with pytest.raises(ValueError, match="unsupported device"):
        G.hit_spheres_cols(tab, *meta)
    with pytest.raises(ValueError, match="unsupported device"):
        H.hit_triangles_cols(tris, *meta)


def test_record_cols_views_the_kernel_buffers():
    """The column record a kernel writes (out_f [N, 12], out_i [N, 2]) is
    viewed field by field in csrc/common.cuh store_record's order."""
    n = 5
    out_f = torch.arange(n * 12, dtype=torch.float32).reshape(n, 12)
    out_i = torch.arange(n * 2, dtype=torch.int32).reshape(n, 2)
    hit = torch.tensor([True, False, True, True, False])
    rec = G.record_cols(out_f, out_i, hit)
    assert torch.equal(rec.t, out_f[:, 0]) and torch.equal(rec.ior, out_f[:, 11])
    assert rec.point.shape == rec.normal.shape == rec.albedo.shape == (n, 3)
    assert torch.equal(rec.normal[:, 0], out_f[:, 4])
    assert torch.equal(rec.idx, out_i[:, 0]) and torch.equal(rec.mat_id, out_i[:, 1])


def test_combine_hits_matches_reference():
    n = 1000

    def rec(seed):
        r = np.random.default_rng(seed)
        t = np.where(r.uniform(size=n) < 0.3, 1e30,
                     r.uniform(0.1, 5, n)).astype(np.float32)
        return dict(hit=t < 1e30, t=t,
                    point=r.normal(size=(n, 3)).astype(np.float32),
                    normal=r.normal(size=(n, 3)).astype(np.float32),
                    idx=r.integers(0, 300, n).astype(np.int32),
                    mat_id=r.integers(0, 3, n).astype(np.int32),
                    albedo=r.uniform(size=(n, 3)).astype(np.float32),
                    fuzz=r.uniform(size=n).astype(np.float32),
                    ior=r.uniform(1, 2, n).astype(np.float32))
    a, b = rec(12), rec(13)
    b["t"][:50] = a["t"][:50]        # exact ties keep geometry A
    ours = combine_hits(HitRecord(**{k: torch.from_numpy(v) for k, v in a.items()}),
                        HitRecord(**{k: torch.from_numpy(v) for k, v in b.items()}),
                        idx_offset_b=128)
    ref = jax_combine(JRec(**{k: jnp.asarray(v) for k, v in a.items()}),
                      JRec(**{k: jnp.asarray(v) for k, v in b.items()}),
                      idx_offset_b=128)
    for f in HitRecord._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_get_hit_fn_routing():
    """"auto" and "pallas" give kernels G and H (their plain versions for
    CPU tensors), "jnp" the plain sweeps on any device, "pallas" off a
    card raises; there is no grid on the wavefront, so a mesh of any size
    gets the brute sweep."""
    auto, jnp_cfg = RenderConfig(), RenderConfig(backend="jnp")
    assert get_hit_fn(auto, "cpu") is G.hit_spheres_cols
    assert get_hit_fn(RenderConfig(backend="pallas"), "cuda") is G.hit_spheres_cols
    assert get_hit_fn(jnp_cfg, "cuda") is hit_spheres
    big = tb.get_scene("mesh20k").triangles
    assert get_hit_fn(auto, "cuda", big) is H.hit_triangles_cols
    assert get_hit_fn(RenderConfig(accel="grid"), "cuda", big) is H.hit_triangles_cols
    assert get_hit_fn(jnp_cfg, "cuda", big) is hit_triangles
    assert get_hit_fn(auto, "cuda", tb.random_scene()) is G.hit_spheres_cols
    with pytest.raises(ValueError, match="CUDA"):
        get_hit_fn(RenderConfig(backend="pallas"), "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        get_hit_fn(RenderConfig(backend="xla"), "cpu")
    with pytest.raises(ValueError, match="empty composite"):
        make_hit_fn(CompositeScene(None, None), hit_spheres)
    # A composite without one side is that side's sweep.
    sph = tb.random_scene()
    tris = tb.mesh_scene().triangles
    o, d, t = _t(*_sphere_rays(256, seed=6))
    only_s = get_hit_fn(auto, "cpu", CompositeScene(sph, None))
    only_t = get_hit_fn(auto, "cpu", CompositeScene(None, tris))
    for x, y in zip(only_s(CompositeScene(sph, None), o, d, t), hit_spheres(sph, o, d, t)):
        assert torch.equal(x, y)
    for x, y in zip(only_t(CompositeScene(None, tris), o, d, t), hit_triangles(tris, o, d, t)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tables", [False, True])
def test_make_hit_fn_composite_matches_reference(tables):
    """The mesh scene's composite (spheres, then triangles, nearest kept,
    triangle indices after the spheres'), on the scene and on its
    tables, against the JAX package's make_hit_fn."""
    o, d, t = _tri_rays(2048, seed=7)
    ts, js = tb.mesh_scene(), jb.mesh_scene()
    hit_scene = hit_tables(ts) if tables else ts
    ours = get_hit_fn(RenderConfig(), "cpu", ts)(hit_scene, *_t(o, d, t))
    ref = jax_make_hit_fn(js, jax_hit_spheres)(js, jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(t))
    a, b = _np(ours), _np(ref)
    assert (a["hit"] == b["hit"]).mean() >= 0.999
    agree = a["hit"] & b["hit"] & (a["idx"] == b["idx"])
    assert agree.mean() >= 0.999 * a["hit"].mean()
    s = ts.spheres.padded_size
    assert (a["idx"][agree] >= s).any() and (a["idx"][agree] < s).any()
    np.testing.assert_allclose(a["t"][agree], b["t"][agree], rtol=1e-4)
    for f in ("mat_id", "albedo", "fuzz", "ior"):
        np.testing.assert_array_equal(a[f][agree], b[f][agree], err_msg=f)
