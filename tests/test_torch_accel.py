"""PyTorch port: the sphere grid (accel.py) against the JAX package's.

The grid's arrays are built on the host by the same numpy code and must be
equal.  The footprint mask is the same torch and jnp code on the same
inputs; XLA's CPU code may fuse ``ox + lo_t * dx`` into one rounding where
torch rounds twice (ROADMAP Queue 3), which could flip a (block,
tile) entry whose footprint ends exactly on a tile edge, so the mask is
held to at most 0.1% of its entries differing (0 differed on these batches
when the test was written).  The plain grid sweep is held to the
reference's jnp oracle as the reference holds that oracle to its brute
sweep (every disagreement on a grazing ray, where f32 rounding decides the
hit), and to the port's own brute sweep exactly: both evaluate the same
f32 pair test, and the grid's tiles keep ascending index order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import accel as JA
from win32_raytracer_tpu.kernels.hit_grid_rows import footprint_block_mask_rows as jmask_rows
from win32_raytracer_tpu.ops.hit import hit_spheres as jax_hit
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch import accel as TA
from win32_raytracer_tpu_torch.ops.hit import hit_spheres
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

torch.set_num_threads(1)

MASK_FLIP_SHARE = 1e-3


@pytest.fixture(scope="module")
def scenes():
    js = jb.random_scene()
    ts = scene_from_numpy(js)
    return js, ts, JA.build_grid_accel(js, time_hi=0.05), TA.build_grid_accel(ts, time_hi=0.05)


def _batch(n, seed, mode, rb=256):
    """Rays [N, 3] f32 and times [N]: camera-like primaries, clustered
    bounce blocks (so the mask skips tiles), and in-slab grazers."""
    rng = np.random.default_rng(seed)
    if mode == "primary":
        o = np.tile([15.0, 2.0, 4.0], (n, 1)) + rng.normal(0, 0.05, (n, 3))
        d = rng.uniform([-12, 0, -12], [12, 2.5, 12], (n, 3)) - o
    elif mode == "bounce":
        centers = rng.uniform([-11, 0.0, -11], [11, 0.4, 11], (n // rb, 3))
        o = (np.repeat(centers, rb, axis=0)
             + rng.uniform(-0.5, 0.5, (n, 3)) * [1.0, 0.4, 1.0])
        d = rng.normal(0, 0.55, (n, 3)) + [0.0, 1.0, 0.0]
    else:  # grazing: nearly horizontal rays inside the slab
        o = rng.uniform([-12, 0.05, -12], [12, 0.5, 12], (n, 3))
        d = rng.normal(0, 1, (n, 3))
        d[:, 1] *= 0.01
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            rng.uniform(0, 0.05, n).astype(np.float32))


def _is_grazing(scene, o, d, tm, lane, tol=1e-4):
    """Ray ``lane`` has a near-zero float64 discriminant against some
    active sphere: its hit legitimately depends on f32 rounding."""
    f = {k: np.asarray(getattr(scene, k), np.float64)
         for k in ("center1", "center2", "t1", "t2", "radius")}
    lerp = (float(tm[lane]) - f["t1"]) / (f["t2"] - f["t1"])
    oc = o[lane].astype(np.float64) - (f["center1"] + (f["center2"] - f["center1"])
                                      * lerp[:, None])
    dv = d[lane].astype(np.float64)
    b = oc @ dv
    disc = b * b - (dv @ dv) * ((oc * oc).sum(1) - f["radius"] ** 2)
    return bool((np.asarray(scene.active)
                 & (np.abs(disc) / np.maximum(b * b, 1e-12) < tol)).any())


@pytest.mark.parametrize("name,time_hi", [("final", 0.05), ("final", 1.0),
                                          ("random", 0.05), ("random", 1.0)])
def test_grid_arrays_match_reference(name, time_hi):
    js = jb.get_scene(name)
    ref = JA.build_grid_accel(js, time_hi=time_hi)
    ours = TA.build_grid_accel(scene_from_numpy(js), time_hi=time_hi)
    assert ours.n_tiles == ref.n_tiles and ours.tile_rows == ref.tile_rows
    for f in ("glob_attrs", "tile_attrs", "tile_boxes", "y_slab"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    back = TA.grid_from_numpy(ref)
    for f in ("glob_attrs", "tile_attrs", "tile_boxes", "y_slab"):
        assert torch.equal(getattr(back, f), getattr(ours, f)), f


def test_declines_and_memo():
    """None where the reference declines (the test scene; too few small
    spheres; a tile over max_tile_rows); the build is memoised on the
    scene object's identity."""
    for js in (jb.test_scene(), jb.random_scene()):
        ts = scene_from_numpy(js)
        for kw in ({}, dict(min_gridded=10_000), dict(max_tile_rows=8)):
            assert ((TA.build_grid_accel(ts, **kw) is None)
                    == (JA.build_grid_accel(js, **kw) is None)), kw
    assert TA.build_grid_accel(scene_from_numpy(jb.test_scene())) is None
    ts = scene_from_numpy(jb.random_scene())
    g = TA.build_grid_accel(ts, time_hi=0.05)
    assert g is not None and g.base is ts
    assert TA.build_grid_accel(ts, time_hi=0.05) is g
    assert TA.build_grid_accel(ts, time_hi=1.0) is not g
    twin = scene_from_numpy(jb.random_scene())
    assert TA.build_grid_accel(twin, time_hi=0.05) is not g


@pytest.mark.parametrize("mode", ["primary", "bounce", "grazing"])
@pytest.mark.parametrize("layout", ["cols", "rows"])
def test_mask_matches_reference(scenes, mode, layout):
    js, _, jg, tg = scenes
    o, d, tm = _batch(4096, 5, mode)
    cap = np.array(jax_hit(js, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tm)).t)
    if layout == "cols":
        ref = JA.footprint_block_mask(jg, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(cap), 0.001, 256)
        ours = TA.footprint_block_mask(tg, torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       torch.from_numpy(cap), 0.001, 256)
    else:
        ref = jmask_rows(jg, jnp.asarray(o.T), jnp.asarray(d.T),
                         jnp.asarray(cap[None]), 0.001, 256)
        ours = TA.footprint_block_mask_rows(
            tg, torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy()),
            torch.from_numpy(cap[None].copy()), 0.001, 256)
    ref = np.asarray(ref)
    assert ours.dtype == torch.int32 and ours.shape == ref.shape
    assert (ours.numpy() != ref).mean() <= MASK_FLIP_SHARE
    if mode == "bounce":
        assert 0 < ref.mean() < 0.75       # the clustered blocks skip tiles
    up = np.tile(np.float32([[0.0, 1.0, 0.0]]), (4096, 1))
    o_up = o.copy()
    o_up[:, 1] = 5.0
    none = TA.footprint_block_mask(tg, torch.from_numpy(o_up), torch.from_numpy(up),
                                   torch.full((4096,), 1e30), 0.001, 256)
    assert int(none.sum()) == 0            # above the slab, pointing away


@pytest.mark.parametrize("mode", ["primary", "bounce", "grazing"])
def test_plain_grid_matches_reference_and_brute(scenes, mode):
    js, ts, jg, tg = scenes
    o, d, tm = _batch(1536, {"primary": 11, "bounce": 22, "grazing": 33}[mode],
                      mode)
    ref = JA.hit_spheres_grid_jnp(jg, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(tm), ray_block=256)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    ours = TA.hit_spheres_grid_plain(tg, *args, ray_block=256)
    brute = hit_spheres(ts, *args)
    for f in ours._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      getattr(brute, f).numpy(), err_msg=f)

    h_ref, h_got = np.asarray(ref.hit), ours.hit.numpy()
    agree = (h_ref == h_got) & (np.asarray(ref.idx) == ours.idx.numpy())
    agree |= ~h_ref & ~h_got
    for lane in np.flatnonzero(~agree):
        assert _is_grazing(js, o, d, tm, lane), lane
    assert (~agree).mean() < 0.005
    ok = agree & h_ref
    np.testing.assert_array_equal(ours.mat_id.numpy()[ok], np.asarray(ref.mat_id)[ok])
    np.testing.assert_allclose(ours.t.numpy()[ok], np.asarray(ref.t)[ok],
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(ours.normal.numpy()[ok], np.asarray(ref.normal)[ok],
                               rtol=0, atol=2e-2)


def test_plain_grid_with_inactive_spheres():
    """Inactive spheres are dropped by the build, so the grid's radius gate
    and the brute sweep's active mask agree: the grid equals the brute
    sweep (and the reference's oracle on the hit lanes) with a sixth of the
    spheres switched off."""
    js = jb.random_scene()
    act = np.array(js.active)
    act[np.flatnonzero(act)[::6]] = False
    js = js._replace(active=jnp.asarray(act))
    ts = scene_from_numpy(js)
    jg, tg = JA.build_grid_accel(js, time_hi=0.05), TA.build_grid_accel(ts, time_hi=0.05)
    assert tg is not None
    o, d, tm = _batch(1024, 44, "bounce")
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    ours = TA.hit_spheres_grid_plain(tg, *args, ray_block=256)
    brute = hit_spheres(ts, *args)
    for f in ours._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      getattr(brute, f).numpy(), err_msg=f)
    assert not np.isin(ours.idx.numpy()[ours.hit.numpy()], np.flatnonzero(~act)).any()
    ref = JA.hit_spheres_grid_jnp(jg, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(tm), ray_block=256)
    both = ours.hit.numpy() & np.asarray(ref.hit)
    assert (ours.idx.numpy()[both] == np.asarray(ref.idx)[both]).mean() > 0.998


def test_rows_plain_pads_and_guards():
    """The rows form pads N to the block as the reference's rows kernel
    does and equals the column form; a schedule over the reference's 768
    KiB SMEM budget raises its ValueError."""
    tg = TA.build_grid_accel(scene_from_numpy(jb.random_scene()), time_hi=0.05)
    o, d, tm = _batch(512, 5, "bounce")
    o, d, tm = o[:300], d[:300], tm[:300]
    rows = TA.hit_spheres_grid_rows_plain(
        tg, torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy()),
        torch.from_numpy(tm[None].copy()), ray_block=256)
    cols = TA.hit_spheres_grid_plain(tg, torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tm), ray_block=256)
    assert rows.hit.shape == (1, 300)
    for f in rows._fields:
        a, b = getattr(rows, f), getattr(cols, f)
        np.testing.assert_array_equal(a.numpy(), (b.T if b.dim() == 2 else b[None]).numpy(),
                                      err_msg=f)
    with pytest.raises(ValueError, match="768 KiB"):
        TA.check_schedule_size(4096, tg.n_tiles)
    TA.check_schedule_size(1920, tg.n_tiles)   # the headline's 3,932,160 lanes
