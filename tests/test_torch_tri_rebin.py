"""PyTorch port: the triangle grid's working-set rebin and DDA arms
(``tri_rebin`` "on" / "dda", kernels/tri_rebin.py and tri_dda.py) and
``tri_sub_gate``, against the JAX package and against the port's direct
pass.

Inputs: ``mesh_scene(subdivisions=3)``'s 1,292 triangles in tiles of 64
rows, 640 rays from tests/test_tri_grid.py (origins uniform in [-4, 4]^3,
normal directions) with its capped mix (half the lanes capped in
[0.1, 3.0], the rest 3.4e38).

Tolerances.  Keys and pair slots: equal, but a last-place difference in a
point (XLA's CPU code may fuse ``o + t * d`` into one rounding, torch
rounds twice) can move it across a cell boundary; at most 1 in 200 keys
may flip (0 measured on 10 ray sets, 12,800 keys, when the test was
written), and the slots' floats agree within 2 f32 ulps of their scale
where the keys agree (0 measured).  Passes: the reference's effective-record
contract (tests/test_tri_grid.py): the lanes whose hit survives the cap
agree; there ``sorted_tri_pass`` equals the direct pass in every field and
``dda_tri_pass`` has t within 2e-5 and equal idx and mat_id.  Against the
JAX functions the records are held to tests/test_torch_tri_hit.py's
tolerances (``_hold``), as the port's plain grid sweep is.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import tri_accel as jacc
from win32_raytracer_tpu.api import render as jax_render
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.kernels import tri_dda as JD
from win32_raytracer_tpu.kernels import tri_rebin as JR
from win32_raytracer_tpu.ops.rows import HitRecordRows as JRec
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch import tri_accel as tacc
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.kernels import dispatch as D
from win32_raytracer_tpu_torch.kernels import tri_dda as TD
from win32_raytracer_tpu_torch.kernels import tri_rebin as TR
from win32_raytracer_tpu_torch.ops.rows import HitRecordRows
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene.spheres import scene_from_numpy

from test_torch_tri_hit import _hold, _tris

torch.set_num_threads(1)

KEY_FLIPS_MAX = 1 / 200
SMALL = dict(width=32, height=16, samples=8, seed=5)


def _grids():
    return (tacc.build_tri_grid(tb.mesh_scene(subdivisions=3).triangles,
                                tile_rows=64),
            jacc.build_tri_grid(jb.mesh_scene(subdivisions=3).triangles,
                                tile_rows=64))


def _rays(seed=7, n=640):
    """tests/test_tri_grid.py's rays and capped mix: (o, d, cap [1, N])."""
    rng = np.random.default_rng(seed)
    o = np.asarray(rng.uniform(-4, 4, (3, n)), np.float32)
    d = np.asarray(rng.normal(size=(3, n)), np.float32)
    rng = np.random.default_rng(3)
    cap = np.where(rng.random(n) < 0.5, rng.uniform(0.1, 3.0, n),
                   3.4e38).astype(np.float32)[None]
    return o, d, cap


def _plain(g, o, d, t, min_t=0.001, t_cap=None):
    return tacc.hit_triangles_grid_rows_plain(g, o, d, t, min_t=min_t,
                                              t_cap=t_cap, ray_block=256)


def _jnp(g, o, d, t, min_t=0.001, t_cap=None):
    return jacc.hit_triangles_grid_rows_jnp(g, o, d, t, min_t=min_t,
                                            t_cap=t_cap, ray_block=256)


def _torch(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


def _live(rec, cap):
    return np.asarray(rec.hit)[0] & (np.asarray(rec.t)[0] < cap[0])


def test_grids_are_the_same():
    tg, jg = _grids()
    assert tg.n_tiles == jg.n_tiles == 21
    np.testing.assert_array_equal(tg.scene_box.numpy(),
                                  np.asarray(jg.scene_box))
    np.testing.assert_array_equal(tg.tile_attrs.numpy(),
                                  np.asarray(jg.tile_attrs))


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_capped_chord_keys_match_reference(seed):
    tg, jg = _grids()
    o, d, cap = _rays(seed)
    ours = TR.capped_chord_keys(tg.scene_box, *_torch(o, d, cap[0])).numpy()
    ref = np.asarray(JR.capped_chord_keys(jg.scene_box, jnp.asarray(o),
                                          jnp.asarray(d), jnp.asarray(cap[0])))
    assert ours.dtype == ref.dtype == np.int32
    assert (ours != ref).mean() <= KEY_FLIPS_MAX, (ours != ref).sum()
    # Both kinds of key occur: lanes that touch the box and lanes that miss.
    assert (ref == TR._NO_TOUCH).any() and (ref != TR._NO_TOUCH).sum() > 30


@pytest.mark.parametrize("k_max", [4, 12])
def test_dda_pairs_match_reference(k_max):
    tg, jg = _grids()
    o, d, cap = _rays()
    ours = [x.numpy() for x in TD.dda_pairs(tg.scene_box, *_torch(o, d, cap[0]),
                                            k_max=k_max)]
    ref = [np.asarray(x) for x in JD.dda_pairs(
        jg.scene_box, jnp.asarray(o), jnp.asarray(d), jnp.asarray(cap[0]),
        k_max=k_max)]
    assert [x.shape for x in ours] == [x.shape for x in ref]
    assert [x.dtype for x in ours] == [x.dtype for x in ref]
    key_o, key_r = ours[0], ref[0]
    assert (key_o != key_r).mean() <= KEY_FLIPS_MAX, (key_o != key_r).sum()
    np.testing.assert_array_equal(ours[5], ref[5])            # lane
    same = key_o == key_r
    live = same & (key_r != TD._DEAD_KEY)
    assert live.sum() > 30 and (~live & same).any()
    for name, a, b in zip(("o_p", "d_p", "cap_p", "t_off"), ours[1:5], ref[1:5]):
        scale = np.maximum(np.abs(b), 1.0)
        assert (np.abs(a - b) <= 2 * np.spacing(scale.astype(np.float32)))[
            ..., same].all(), name
    # Dead slots are parked with cap 0.
    dead = key_o == TD._DEAD_KEY
    assert (ours[3][0, dead] == 0).all()
    assert (ours[1][1, dead] == np.float32(-1e9)).all()


def test_sorted_tri_pass_matches_direct():
    """The port's working-set pass against its direct pass: the same
    effective records, every field."""
    tg, _ = _grids()
    o, d, cap = _rays()
    o_t, d_t, cap_t = _torch(o, d, cap)
    tm = torch.zeros(1, o.shape[1])
    direct = _plain(tg, o_t, d_t, tm, t_cap=cap_t)
    srt = TR.sorted_tri_pass(_plain, tg, o_t, d_t, tm, cap_t)
    live = _live(direct, cap)
    np.testing.assert_array_equal(_live(srt, cap), live)
    assert live.any()
    for f, a, b in zip(HitRecordRows._fields, srt, direct):
        assert a.dtype == b.dtype and a.is_contiguous(), f
        np.testing.assert_array_equal(a.numpy()[:, live], b.numpy()[:, live],
                                      err_msg=f)


@pytest.mark.parametrize("k_max", [4, 12])
def test_dda_tri_pass_matches_direct(k_max):
    tg, _ = _grids()
    o, d, cap = _rays()
    o_t, d_t, cap_t = _torch(o, d, cap)
    tm = torch.zeros(1, o.shape[1])
    direct = _plain(tg, o_t, d_t, tm, t_cap=cap_t)
    dda = TD.dda_tri_pass(_plain, tg, o_t, d_t, tm, cap_t, k_max=k_max)
    live = _live(direct, cap)
    np.testing.assert_array_equal(_live(dda, cap), live)
    assert live.any()
    np.testing.assert_allclose(dda.t.numpy()[0, live], direct.t.numpy()[0, live],
                               rtol=2e-5, atol=2e-5)
    for f in ("idx", "mat_id"):
        np.testing.assert_array_equal(getattr(dda, f).numpy()[0, live],
                                      getattr(direct, f).numpy()[0, live])
    for f, a, b in zip(HitRecordRows._fields, dda, direct):
        assert a.dtype == b.dtype and a.shape == b.shape, f


@pytest.mark.parametrize("arm", ["on", "dda"])
def test_passes_match_reference(arm):
    """The port's pass with its plain sweep against the JAX function with
    its jnp sweep, on the same rays: the same surviving lanes, each held to
    the plain grid sweep's tolerances against the JAX package (``_hold``),
    and for DDA the same t to 2e-5."""
    tg, jg = _grids()
    o, d, cap = _rays()
    o_t, d_t, cap_t = _torch(o, d, cap)
    n = o.shape[1]
    if arm == "on":
        ours = TR.sorted_tri_pass(_plain, tg, o_t, d_t, torch.zeros(1, n), cap_t)
        ref = JR.sorted_tri_pass(_jnp, jg, jnp.asarray(o), jnp.asarray(d),
                                 jnp.zeros((1, n)), jnp.asarray(cap))
    else:
        ours = TD.dda_tri_pass(_plain, tg, o_t, d_t, torch.zeros(1, n), cap_t)
        ref = JD.dda_tri_pass(_jnp, jg, jnp.asarray(o), jnp.asarray(d),
                              jnp.zeros((1, n)), jnp.asarray(cap))
    live = _live(ref, cap)
    np.testing.assert_array_equal(_live(ours, cap), live)
    if arm == "on":
        agree = _hold(ours, ref, o, d, _tris(jg.base), live)
        assert agree.sum() == live.sum() > 10
    else:
        np.testing.assert_allclose(ours.t.numpy()[0, live],
                                   np.asarray(ref.t)[0, live], rtol=2e-5,
                                   atol=2e-5)
        for f in ("idx", "mat_id"):
            np.testing.assert_array_equal(getattr(ours, f).numpy()[0, live],
                                          np.asarray(getattr(ref, f))[0, live])


def test_dda_merge_takes_the_reference_winner_on_a_t_tie(monkeypatch):
    """Two slots of a lane with equal t: the reference's unsort leaves a
    lane's slots in cell-key order (ties by slot), and its argmin takes
    the first of them.  Lane 0's slot 1 keys a lower cell than its slot 0,
    so slot 1 wins in both packages; a merge in slot order would take
    slot 0.  A stub sweep hits every live pair at t = 1 and reports the
    slot (carried in the pair's origin x) as idx."""
    n, k = 3, 3
    key = np.array([5, 9, 2, 3, 1, 2, 7, 1 << 20, 2], np.int32)  # [K*N]
    slot = np.repeat(np.arange(k), n).astype(np.float32)
    o_p = np.stack([slot, np.zeros(n * k), np.zeros(n * k)]).astype(np.float32)
    d_p = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, n * k))
    cap = np.where(key == 1 << 20, 0.0, 5.0).astype(np.float32)[None]
    off = np.zeros(n * k, np.float32)
    lane = np.tile(np.arange(n), k).astype(np.int32)
    pairs = (key, o_p, d_p, cap, off, lane)

    def stub(rec_type, xp):
        def sweep(g, o2, d2, t2, min_t=0.001, t_cap=None):
            m = o2.shape[1]
            live = t_cap[0] > 0
            ones = xp.ones((1, m), dtype=xp.float32)
            return rec_type(
                hit=live[None], t=ones, point=xp.zeros((3, m), dtype=xp.float32),
                normal=xp.zeros((3, m), dtype=xp.float32),
                idx=o2[0:1].astype(xp.int32) if xp is jnp
                else o2[0:1].to(torch.int32),
                mat_id=xp.zeros((1, m), dtype=xp.int32), albedo=xp.zeros(
                    (3, m), dtype=xp.float32), fuzz=ones, ior=ones)
        return sweep

    class Grid:
        scene_box = None
    monkeypatch.setattr(JD, "dda_pairs", lambda *a, **kw: tuple(
        jnp.asarray(x) for x in pairs))
    monkeypatch.setattr(TD, "dda_pairs", lambda *a, **kw: tuple(
        torch.from_numpy(x.copy()) for x in pairs))
    z3 = np.zeros((3, n), np.float32)
    ref = JD.dda_tri_pass(stub(JRec, jnp), Grid, jnp.asarray(z3),
                          jnp.asarray(z3), jnp.zeros((1, n)),
                          jnp.zeros((1, n)), k_max=k)
    ours = TD.dda_tri_pass(stub(HitRecordRows, torch), Grid,
                           torch.from_numpy(z3), torch.from_numpy(z3),
                           torch.zeros(1, n), torch.zeros(1, n), k_max=k)
    want = np.asarray(ref.idx)[0]
    # Lane 0: slots keyed 5, 3, 7 -> slot 1 first; lane 1: 9, 1, dead ->
    # slot 1; lane 2: 2, 2, 2 -> ties by slot, slot 0.
    np.testing.assert_array_equal(want, [1, 1, 0])
    np.testing.assert_array_equal(ours.idx.numpy()[0], want)
    np.testing.assert_array_equal(ours.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(ours.t.numpy(), np.asarray(ref.t))


@functools.lru_cache(maxsize=None)
def _linear(cfg):
    """The linear image of mesh_scene(subdivisions=3) under ``cfg`` (each
    configuration rendered once in this module)."""
    return TP.render_image_persistent(tb.mesh_scene(subdivisions=3), None,
                                      cfg).numpy()


def _sq_diff(a, b):
    return np.abs(np.sqrt(np.clip(a, 0, 1)) - np.sqrt(np.clip(b, 0, 1)))


def test_rebin_render_equals_off():
    """tri_rebin="on" never permutes the path state: the render is the
    rebin-off render bit for bit."""
    cfg = TC(accel="grid", ray_binning="off", **SMALL)
    base = _linear(cfg)
    np.testing.assert_array_equal(_linear(cfg.replace(tri_rebin="on")),
                                  base)


@pytest.mark.parametrize("k", [0, 12])
def test_dda_render_within_envelope(k):
    """tri_rebin="dda" (K = 4, and tri_dda_k=12) against the rebin-off
    render, in the reference's envelope: mean |diff| of the square-rooted
    images < 2e-3 and under 1% of pixels more than 8/255 apart."""
    cfg = TC(accel="grid", ray_binning="off", **SMALL)
    diff = _sq_diff(_linear(cfg.replace(tri_rebin="dda", tri_dda_k=k)),
                    _linear(cfg))
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 8 / 255).mean() < 0.01, (diff > 8 / 255).mean()


# Mean |diff| in u8 and Pearson r of the port's rebin render against the JAX
# package's, about 2x the values measured when the test was written (seed 5,
# 32x16, 8 spp: 0.0 / 1.0, the images equal); no lane permutation, so near
# test_torch_tri_grid_render's "compaction" row.
REBIN_BOUNDS = (0.015, 0.99999)


def test_rebin_render_matches_reference():
    scene = jb.mesh_scene(subdivisions=3)
    kw = dict(accel="grid", ray_binning="off", tri_rebin="on", **SMALL)
    ref = jax_render(scene, cfg=JC(backend="jnp", **kw)).image
    ours = render(scene_from_numpy(scene), cfg=TC(**kw), device="cpu").image
    a, b = ours.astype(np.float64), ref.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    d = float(np.abs(a - b).mean())
    assert d <= REBIN_BOUNDS[0] and r >= REBIN_BOUNDS[1], (d, r)


@pytest.mark.parametrize("q", [1, 2, 4, 8, 16])
def test_sub_gate_renders_equal_auto(q):
    """tri_sub_gate changes no record (kernel D gates per CTA of 32 lanes,
    finer than any sub-group): each value renders the default's image."""
    cfg = TC(accel="grid", **SMALL)
    np.testing.assert_array_equal(_linear(cfg.replace(tri_sub_gate=q)),
                                  _linear(cfg))


def test_sub_gate_bad_split_raises():
    """The reference kernel's refusal of a sub-group that is not a multiple
    of 128 lanes, on the kernels backend with the any-touch skip on; not
    under "jnp" or with the skip off, where the reference ignores the
    knob."""
    scene = tb.mesh_scene(subdivisions=3)
    bad = TC(accel="grid", tri_ray_block=256, tri_sub_gate=4)
    with pytest.raises(ValueError, match="128-lane multiples"):
        D.get_hit_fn_rows_accel(bad, scene)
    D.get_hit_fn_rows_accel(bad.replace(backend="jnp"), scene)
    D.get_hit_fn_rows_accel(bad.replace(tri_any_skip="off"), scene)
    D.get_hit_fn_rows_accel(bad.replace(tri_sub_gate=2), scene)


@pytest.mark.parametrize("arm", ["on", "dda"])
def test_rebin_turns_binning_and_auto_one_shot_off(arm):
    """Under the rebin the state is not binned (the triangle pass sorts its
    own working set), and one_shot "auto" resolves to off: the rebin is a
    conflict of the one-shot forms, as in the reference."""
    scene = tb.mesh_scene(subdivisions=3)
    cfg = TC(tri_rebin=arm, **SMALL)
    hit_scene, _ = D.get_hit_fn_rows_accel(cfg, scene)
    assert TP._tri_rebin_active(cfg, hit_scene)
    assert TP._derive_bin_box(cfg, hit_scene) is None
    assert TP._derive_bin_box(cfg.replace(tri_rebin="off"), hit_scene)
    routes = TP.resolve_routes(cfg, hit_scene, "cpu", h_virt=16, kpp=1,
                               bin_box=None)
    assert routes.one_shot == "off"
    brute, _ = D.get_hit_fn_rows_accel(cfg.replace(accel="off"), scene)
    assert not TP._tri_rebin_active(cfg, brute)
