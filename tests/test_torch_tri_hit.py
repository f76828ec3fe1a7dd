"""PyTorch port: the plain triangle sweeps (kernels C and D's references),
the grid schedule and the hit-record merge, against the JAX package.

Kernels C and D themselves (CUDA) are held against these plain sweeps on
the card by chip_smoke.py phases 6 and 7.

Tolerances.  Hit masks and winners must agree, except on at most 1e-4 of
the rays and only where the hit lies within 1e-6 of a triangle edge
(|u|, |v| or |1 - u - v|), where a last-place difference may flip the
decision.  t is held to the float64 Moller-Trumbore root within 4 f32
epsilons of the formula's scale S = (|e1||e2||o - v0| + |t||e1||e2||d|)
/ |det| (both packages measured <= 2.1 eps x S); the two packages' points
within 8 epsilons (4 each) of |o| + |t||d| + S|d| of each other, their
unit normals within 8 epsilons.  XLA's CPU code fuses multiplies and adds
into one rounding where torch rounds each, so the two packages differ in
the last places.  The grid sweeps
are compared only where t < cap: a record beyond a lane's segment end is
unspecified (the reference's contract)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import tri_accel as jacc
from win32_raytracer_tpu.kernels import tri_grid_rows as JG
from win32_raytracer_tpu.ops.hit_tri import hit_triangles as jax_hit_tri
from win32_raytracer_tpu.ops.rows import HitRecordRows as JRec
from win32_raytracer_tpu.ops.rows import combine_hits_rows as jax_combine
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu.scene import triangles as jtri
from win32_raytracer_tpu_torch import tri_accel as tacc
from win32_raytracer_tpu_torch.kernels import tri as KC
from win32_raytracer_tpu_torch.kernels import tri_grid as KD
from win32_raytracer_tpu_torch.ops.hit_tri import tri_table
from win32_raytracer_tpu_torch.ops.rows import HitRecordRows, combine_hits_rows
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene import triangles as ttri

torch.set_num_threads(1)

EPS = 2.0 ** -24


def _mesh(mod, subdiv=3):
    """tests/test_tri_grid.py's 1,292-triangle mesh."""
    v1, f1 = mod.icosphere_mesh((0.0, 1.0, 0.0), 1.0, subdivisions=subdiv)
    v2, f2 = mod.box_mesh((2.0, 0.4, 0.5), (0.8, 0.8, 0.8))
    verts = np.concatenate([v1, v2], axis=0)
    faces = np.concatenate([f1, f2 + len(v1)], axis=0)
    return mod.build_triangle_scene(verts, faces)


def _aimed_rays(n, seed):
    """Rays [3, N] from around the mesh scene toward its meshes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.0, 0.0, -2.0], [3.0, 3.0, 4.0], (n, 3))
    tgt = np.where(rng.uniform(size=(n, 1)) < 0.8,
                   [0.0, 1.0, 0.0] + rng.normal(0, 0.7, (n, 3)),
                   [0.0, 0.35, 2.2] + rng.normal(0, 0.4, (n, 3)))
    d = tgt - o + rng.normal(0, 0.05, (n, 3))
    return o.T.astype(np.float32).copy(), d.T.astype(np.float32).copy()


def _coherent_rays(n, block, seed):
    """Rays [3, N] in blocks of ``block`` that share an origin region and
    a heading (as binned or primary batches do), so block masks are
    sparse."""
    rng = np.random.default_rng(seed)
    nb = n // block
    oc = rng.uniform([-4.0, 0.0, -4.0], [4.0, 3.0, 4.0], (nb, 3))
    tgt = [0.5, 0.8, 0.2] + rng.normal(0, 1.0, (nb, 3))
    o = np.repeat(oc, block, 0) + rng.normal(0, 0.05, (n, 3))
    d = np.repeat(tgt - oc, block, 0) + rng.normal(0, 0.1, (n, 3))
    return o.T.astype(np.float32).copy(), d.T.astype(np.float32).copy()


def _mt_f64(o, d, v0, e1, e2):
    """float64 Moller-Trumbore of rays o/d [3, N] against one triangle per
    ray ([N, 3] each): (t, u, v, scale S)."""
    o, d = o.T.astype(np.float64), d.T.astype(np.float64)
    p = np.cross(d, e2)
    det = (e1 * p).sum(1)
    tv = o - v0
    q = np.cross(tv, e1)
    t = (e2 * q).sum(1) / det
    nrm = np.linalg.norm
    e12 = nrm(e1, axis=1) * nrm(e2, axis=1)
    scale = (e12 * nrm(tv, axis=1) + np.abs(t) * e12 * nrm(d, axis=1)) / np.abs(det)
    return t, (tv * p).sum(1) / det, (d * q).sum(1) / det, scale


def _hold(ours, ref, o, d, tris, valid):
    """Assert the module tolerances between the port's record ``ours``
    (HitRecordRows) and the reference's (HitRecordRows-like, rows) on the
    rays where ``valid``; ``tris`` holds v0/e1/e2 [T, 3] by global index."""
    np_ = {f: np.asarray(getattr(ours, f)) for f in HitRecordRows._fields}
    rf = {f: np.asarray(getattr(ref, f)) for f in HitRecordRows._fields}
    hit_o, hit_r = np_["hit"][0], rf["hit"][0]
    idx_o, idx_r = np_["idx"][0], rf["idx"][0]
    bad = valid & ((hit_o != hit_r) | (hit_o & (idx_o != idx_r)))
    agree = valid & hit_o & hit_r & (idx_o == idx_r)
    for idx, sel in ((idx_o, bad & hit_o), (idx_r, bad & hit_r)):
        if sel.any():
            _, u, v, _ = _mt_f64(o[:, sel], d[:, sel], *(x[idx[sel]] for x in tris))
            edge = np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(1 - u - v))
            assert (edge < 1e-6).all(), edge
    assert bad.mean() <= 1e-4, bad.sum()
    t64, _, _, s = _mt_f64(o, d, *(x[idx_o] for x in tris))
    for got in (np_["t"][0], rf["t"][0]):
        assert (np.abs(got - t64) <= 4 * EPS * s)[agree].all()
    dlen = np.linalg.norm(d, axis=0)
    sp = np.linalg.norm(o, axis=0) + np.abs(t64) * dlen + s * dlen
    assert (np.abs(np_["point"] - rf["point"]) <= 8 * EPS * sp)[:, agree].all()
    assert (np.abs(np_["normal"] - rf["normal"]) <= 8 * EPS)[:, agree].all()
    for f in ("mat_id", "albedo", "fuzz", "ior"):
        np.testing.assert_array_equal(np_[f][:, agree], rf[f][:, agree])
    return agree


def _tris(scene):
    return tuple(np.asarray(getattr(scene, f), np.float64)
                 for f in ("v0", "e1", "e2"))


def test_plain_brute_matches_reference_sweep():
    """Kernel C's plain version against ops/hit_tri.hit_triangles on 4,096
    rays at mesh_scene(subdivisions=2)'s 332 triangles."""
    o, d = _aimed_rays(4096, seed=0)
    ts, js = tb.mesh_scene().triangles, jb.mesh_scene().triangles
    ours = KC.hit_triangles_rows_plain(ts, torch.from_numpy(o),
                                       torch.from_numpy(d), torch.zeros(1, 4096))
    col = jax_hit_tri(js, jnp.asarray(o.T), jnp.asarray(d.T), jnp.zeros(4096))
    ref = JRec(hit=col.hit[None], t=col.t[None], point=col.point.T,
               normal=col.normal.T, idx=col.idx[None], mat_id=col.mat_id[None],
               albedo=col.albedo.T, fuzz=col.fuzz[None], ior=col.ior[None])
    agree = _hold(ours, ref, o, d, _tris(js), np.ones(4096, bool))
    assert 0.5 < agree.mean() < 0.95


def test_brute_wrapper_on_cpu_is_the_plain_sweep():
    o, d = (torch.from_numpy(x) for x in _aimed_rays(512, seed=1))
    tab = tri_table(tb.mesh_scene().triangles)
    before = KC.LAUNCHES
    a = KC.hit_triangles_rows(tab, o, d, torch.zeros(1, 512))
    b = KC.hit_triangles_rows_plain(tab, o, d, torch.zeros(1, 512))
    assert KC.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unsupported device"):
        KC.hit_triangles_rows(tab, o.to("meta"), d.to("meta"),
                              torch.zeros(1, 512, device="meta"))


def test_no_hit_record_is_zero():
    """Misses carry the 1e30 sentinel and all-zero attributes."""
    o = torch.tensor([[0.0], [50.0], [0.0]])
    d = torch.tensor([[0.0], [1.0], [0.0]])
    rec = KC.hit_triangles_rows_plain(tb.mesh_scene().triangles, o, d,
                                      torch.zeros(1, 1))
    assert not rec.hit.item() and rec.t.item() == np.float32(1e30)
    assert rec.idx.item() == 0 and rec.mat_id.item() == 0
    assert torch.equal(rec.point, o) and not rec.normal.any()


def _grids():
    return (tacc.build_tri_grid(_mesh(ttri)), jacc.build_tri_grid(_mesh(jtri)))


def _cap(n, seed):
    return np.random.default_rng(seed).uniform(1.0, 8.0, (1, n)).astype(np.float32)


@pytest.mark.parametrize("with_cap", [False, True])
@pytest.mark.parametrize("ray_block", [256, 512])
def test_schedule_matches_reference(with_cap, ray_block):
    """tri_block_schedule_rows: masks, entry bounds and segment ends
    array-equal to the reference's, on coherent blocks (sparse masks)."""
    tg, jg = _grids()
    o, d = _coherent_rays(4096, 256, seed=2)
    cap = _cap(4096, 3) if with_cap else None
    ours = tacc.tri_block_schedule_rows(
        tg, torch.from_numpy(o), torch.from_numpy(d),
        None if cap is None else torch.from_numpy(cap), 0.001, ray_block)
    ref = jacc.tri_block_schedule_rows(
        jg, jnp.asarray(o), jnp.asarray(d),
        None if cap is None else jnp.asarray(cap), 0.001, ray_block)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0.0 < ours[0].float().mean() < 1.0


def test_block_schedule_matches_reference_prelude():
    """Kernel D's schedule (count, tiles front to back, bounds on the
    1/1024 grid) and quantised boxes, against _tri_grid_raw's prelude
    formulas evaluated by the JAX package."""
    tg, jg = _grids()
    o, d = _coherent_rays(4096, 256, seed=4)
    mask, tlo, _ = jacc.tri_block_schedule_rows(
        jg, jnp.asarray(o), jnp.asarray(d), None, 0.001, 256)
    key = jnp.where(mask > 0, jnp.minimum(tlo, JG._TLO_CAP), JG._TLO_PAD)
    order = jnp.argsort(key, axis=1)
    count = jnp.sum(mask > 0, axis=1, dtype=jnp.int32)
    tlo_q = jnp.floor(jnp.take_along_axis(key, order, axis=1)
                      * JG._TLO_SCALE).astype(jnp.int32)
    sched, bounds = KD.block_schedule(torch.from_numpy(np.array(mask)),
                                      torch.from_numpy(np.array(tlo)))
    np.testing.assert_array_equal(sched[:, 0].numpy(), np.asarray(count))
    np.testing.assert_array_equal(sched[:, 1:].numpy(), np.asarray(order))
    np.testing.assert_array_equal(
        bounds[:, :-1].numpy(),
        np.asarray(tlo_q).astype(np.float32) * JG._TLO_INV)
    assert (bounds[:, -1].numpy() == np.float32(JG._TLO_PAD)).all()
    bclip = jnp.clip(jg.tile_boxes, -JG._BX_CLIP, JG._BX_CLIP) * JG._TLO_SCALE
    want = np.empty((jg.n_tiles, 6), np.float32)
    want[:, 0::2] = (np.asarray(jnp.floor(bclip[:, 0::2]).astype(jnp.int32) - 1)
                     * JG._TLO_INV)
    want[:, 1::2] = (np.asarray(jnp.ceil(bclip[:, 1::2]).astype(jnp.int32) + 1)
                     * JG._TLO_INV)
    np.testing.assert_array_equal(tacc.quantized_boxes(tg.tile_boxes).numpy(),
                                  want)


@pytest.mark.parametrize("with_cap", [False, True])
def test_plain_grid_matches_jnp_twin(with_cap):
    """Kernel D's plain version against hit_triangles_grid_rows_jnp, and
    against the port's own brute sweep (the mask is conservative)."""
    tg, jg = _grids()
    n = 2048
    o, d = _coherent_rays(n, 256, seed=5)
    o[:, :1024], d[:, :1024] = _aimed_rays(1024, seed=6)
    cap = _cap(n, 7) if with_cap else np.full((1, n), 1e30, np.float32)
    cap_t = torch.from_numpy(cap) if with_cap else None
    ours = tacc.hit_triangles_grid_rows_plain(
        tg, torch.from_numpy(o), torch.from_numpy(d), None, ray_block=256,
        t_cap=cap_t)
    ref = jacc.hit_triangles_grid_rows_jnp(
        jg, jnp.asarray(o), jnp.asarray(d), None, ray_block=256,
        t_cap=jnp.asarray(cap) if with_cap else None)
    valid = np.asarray(ref.t)[0] < cap[0]
    agree = _hold(ours, ref, o, d, _tris(jg.base), valid)
    assert agree.sum() > 500
    brute = KC.hit_triangles_rows_plain(tg.base, torch.from_numpy(o),
                                        torch.from_numpy(d), None)
    near = brute.t.numpy()[0] < cap[0]
    for f in HitRecordRows._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy()[:, near],
                                      getattr(brute, f).numpy()[:, near])


@pytest.mark.parametrize("knobs", [True, False])
@pytest.mark.parametrize("with_cap", [False, True])
def test_plain_grid_matches_exact_kernel_interpret(knobs, with_cap):
    """Against the reference's exact grid kernel (interpret mode), with
    its early exit and any-touch skip on and off, at 512 rays."""
    tg, jg = _grids()
    o, d = _coherent_rays(512, 128, seed=8)
    cap = _cap(512, 9) if with_cap else np.full((1, 512), 1e30, np.float32)
    ours = tacc.hit_triangles_grid_rows_plain(
        tg, torch.from_numpy(o), torch.from_numpy(d), None, ray_block=256,
        t_cap=torch.from_numpy(cap) if with_cap else None,
        early_exit=knobs, any_skip=knobs)
    ref = JG.hit_triangles_grid_rows(
        jg, jnp.asarray(o), jnp.asarray(d), None, ray_block=256,
        t_cap=jnp.asarray(cap) if with_cap else None, interpret=True,
        use_mxu=False, early_exit=knobs, any_skip=knobs)
    valid = np.asarray(ref.t)[0] < cap[0]
    agree = _hold(ours, ref, o, d, _tris(jg.base), valid)
    assert agree.sum() > 100


def test_grid_wrapper_on_cpu_is_the_plain_sweep():
    tg, _ = _grids()
    o, d = (torch.from_numpy(x) for x in _coherent_rays(1000, 100, seed=10))
    before = KD.LAUNCHES
    a = KD.hit_triangles_grid_rows(tg, o, d, None, ray_block=512)
    b = tacc.hit_triangles_grid_rows_plain(tg, o, d, None, ray_block=512)
    assert KD.LAUNCHES == before and a.t.shape == (1, 1000)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unsupported device"):
        KD.hit_triangles_grid_rows(tg, o.to("meta"), d.to("meta"), None)


def test_combine_hits_rows_matches_reference():
    n = 1000

    def rec(seed):
        r = np.random.default_rng(seed)
        t = np.where(r.uniform(size=(1, n)) < 0.3, 1e30,
                     r.uniform(0.1, 5, (1, n))).astype(np.float32)
        return dict(hit=t < 1e30, t=t,
                    point=r.normal(size=(3, n)).astype(np.float32),
                    normal=r.normal(size=(3, n)).astype(np.float32),
                    idx=r.integers(0, 300, (1, n)).astype(np.int32),
                    mat_id=r.integers(0, 3, (1, n)).astype(np.int32),
                    albedo=r.uniform(size=(3, n)).astype(np.float32),
                    fuzz=r.uniform(size=(1, n)).astype(np.float32),
                    ior=r.uniform(1, 2, (1, n)).astype(np.float32))
    a, b = rec(12), rec(13)
    b["t"][:, :50] = a["t"][:, :50]        # exact ties keep geometry A
    ours = combine_hits_rows(
        HitRecordRows(**{k: torch.from_numpy(v) for k, v in a.items()}),
        HitRecordRows(**{k: torch.from_numpy(v) for k, v in b.items()}),
        idx_offset_b=128)
    ref = jax_combine(JRec(**{k: jnp.asarray(v) for k, v in a.items()}),
                      JRec(**{k: jnp.asarray(v) for k, v in b.items()}),
                      idx_offset_b=128)
    for f in HitRecordRows._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
