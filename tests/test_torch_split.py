"""PyTorch port: the split bounce's plain versions (kernels E and F's
references) against the JAX package.

Row 4 of the kernel table: the plain hit + sky
(``kernels/hit_sky.hit_sky_plain``) against the reference's ``p_hit_step``
with the exact ``ops.hit`` sweep, and against its v7 hit+sky Pallas kernel
in interpret mode.  Row 5: the plain scatter + respawn
(``kernels/scatter.scatter_respawn_plain``) against the reference's
``p_scatter_respawn_step`` and its Pallas kernel in interpret mode, lean and
not, on one camera and on three.

Kernels E and F themselves (CUDA) are held against these plain versions on
the card by chip_smoke.py phase 9, exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_hit import _root_f64
from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.animation import orbit_path as jax_orbit
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.core.rng import hash_uniform01 as jax_draws
from win32_raytracer_tpu.kernels.hit_pallas_v7 import hit_coeffs, p_hit_sky_step
from win32_raytracer_tpu.kernels.scatter_pallas import scatter_respawn_pallas
from win32_raytracer_tpu.ops.hit import hit_spheres as jax_hit
from win32_raytracer_tpu.ops.rows import HitRecordRows as JRec
from win32_raytracer_tpu.ops.rows import hit_rows_adapter
from win32_raytracer_tpu.scene.builders import random_scene as jax_scene
from win32_raytracer_tpu.scene.camera import Camera as JCamera
from win32_raytracer_tpu.scene.camera import default_camera as jax_camera
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.animation import orbit_path
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.core.rng import hash_uniform01
from win32_raytracer_tpu_torch.kernels import bounce as B
from win32_raytracer_tpu_torch.kernels import hit_sky as E
from win32_raytracer_tpu_torch.kernels import scatter as F
from win32_raytracer_tpu_torch.ops.hit import sphere_table
from win32_raytracer_tpu_torch.ops.rows import HitRecordRows
from win32_raytracer_tpu_torch.scene.builders import random_scene
from win32_raytracer_tpu_torch.scene.camera import default_camera

torch.set_num_threads(1)

W, H, SPP, KPP, RB = 32, 16, 8, 2, 256
SALT = 0xC0FFEE
EPS32 = 2.0 ** -24


def _random_state(n, seed):
    """A random state (a fifth of the lanes dead), as numpy arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        origin=rng.uniform(-12, 12, (3, n)).astype(np.float32),
        direction=rng.normal(0, 1, (3, n)).astype(np.float32),
        time=rng.uniform(0, 0.05, (1, n)).astype(np.float32),
        throughput=rng.uniform(0, 1, (3, n)).astype(np.float32),
        radiance_sum=rng.uniform(0, 1, (3, n)).astype(np.float32),
        depth=np.ones((1, n), np.int32),
        sample=np.zeros((1, n), np.int32),
        pixel=np.arange(n, dtype=np.int32)[None],
        path_alive=rng.uniform(0, 1, (1, n)) < 0.8,
        s_base=np.zeros((1, n), np.int32),
        s_quota=np.full((1, n), SPP // KPP, np.int32),
    )


def _torch_state(arrs):
    return TP.PathState(**{k: torch.from_numpy(np.array(v))
                           for k, v in arrs.items()})


def _jax_state(arrs):
    return JP.PathState(**{k: jnp.asarray(v) for k, v in arrs.items()})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- row 4: hit + sky ----------------------------------------------------

def test_plain_hit_sky_matches_reference_step():
    """Against p_hit_step with the exact ops.hit sweep: the same winners,
    t within 4 f32 epsilons of the float64 root's scale (the stance of
    test_torch_hit.py), the radiance of lanes that miss within f32
    round-off, and dead lanes' radiance and alive flag passed through."""
    arrs = _random_state(2048, seed=21)
    cfg = dict(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    rec, st = E.hit_sky_plain(sphere_table(random_scene()),
                              _torch_state(arrs), cfg=TC(**cfg))
    jscene = jax_scene()
    rec_j, st_j = JP.p_hit_step(jscene, _jax_state(arrs), cfg=JC(**cfg),
                                hit_fn=hit_rows_adapter(jax_hit))
    hit, hit_j = _np(rec.hit)[0], _np(rec_j.hit)[0]
    idx, idx_j = _np(rec.idx)[0], _np(rec_j.idx)[0]
    assert 0.2 < hit.mean() < 0.95
    assert (hit == hit_j).mean() >= 0.999 and (idx == idx_j).mean() >= 0.999
    agree = (hit == hit_j) & (idx == idx_j)
    both = agree & hit
    root, scale = _root_f64(arrs["origin"], arrs["direction"], arrs["time"],
                            jscene, idx)
    for t in (_np(rec.t)[0], _np(rec_j.t)[0]):
        assert (np.abs(t - root) <= 4 * EPS32 * scale)[both].all()
    for f in ("albedo", "fuzz", "ior", "mat_id"):
        np.testing.assert_array_equal(_np(getattr(rec, f))[:, both],
                                      _np(getattr(rec_j, f))[:, both])
    alive_in = arrs["path_alive"][0]
    np.testing.assert_array_equal(_np(st.path_alive)[0][agree],
                                  _np(st_j.path_alive)[0][agree])
    np.testing.assert_array_equal(_np(st.path_alive)[0], alive_in & hit)
    rad, rad_j = _np(st.radiance_sum), _np(st_j.radiance_sum)
    np.testing.assert_allclose(rad[:, agree], rad_j[:, agree], rtol=1e-6,
                               atol=1e-7)
    untouched = ~alive_in | hit
    np.testing.assert_array_equal(rad[:, untouched],
                                  arrs["radiance_sum"][:, untouched])


def test_plain_hit_sky_matches_v7_kernel_interpret():
    """Against the v7 hit+sky Pallas kernel: its split-bf16 quadratic
    flips winners at ~1e-4 (test_torch_hit.py holds v6 to 1%); the same
    bound here for winners, hit mask and alive flags, and the radiance of
    the lanes that agree within f32 round-off."""
    arrs = _random_state(1024, seed=22)
    rec, st = E.hit_sky_plain(sphere_table(random_scene()),
                              _torch_state(arrs), cfg=TC())
    rec_j, st_j = p_hit_sky_step(hit_coeffs(jax_scene()), _jax_state(arrs),
                                 ray_block=1024, interpret=True)
    hit, hit_j = _np(rec.hit)[0], _np(rec_j.hit)[0]
    idx, idx_j = _np(rec.idx)[0], _np(rec_j.idx)[0]
    assert (hit != hit_j).mean() < 0.01 and (idx != idx_j).mean() < 0.01
    alive, alive_j = _np(st.path_alive)[0], _np(st_j.path_alive)[0]
    assert (alive != alive_j).mean() < 0.01
    agree = (hit == hit_j) & (idx == idx_j)
    np.testing.assert_allclose(_np(st.radiance_sum)[:, agree],
                               _np(st_j.radiance_sum)[:, agree],
                               rtol=1e-5, atol=1e-6)


def test_hit_sky_wrapper_on_cpu_is_the_plain_step():
    st = _torch_state(_random_state(512, seed=23))
    tab = sphere_table(random_scene())
    before = E.LAUNCHES
    rec, out = E.hit_sky(tab, st, cfg=TC())
    rec_p, out_p = E.hit_sky_plain(tab, st, cfg=TC())
    assert E.LAUNCHES == before
    for x, y in zip(tuple(rec) + tuple(out), tuple(rec_p) + tuple(out_p)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unsupported device"):
        E.hit_sky(tab, st._replace(origin=st.origin.to("meta")), cfg=TC())


# ---- row 5: scatter + respawn --------------------------------------------

def _extra(lean):
    """Stratification and roulette (lean off) or neither (lean on)."""
    return {} if lean else dict(stratify=True, russian_roulette=True,
                                rr_start_depth=1)


@pytest.fixture(scope="module", params=[1, 3], ids=["1cam", "3cams"])
def mid_render(request):
    """The reference's state two bounces into a render of ``frames``
    frames (one camera, or three orbit cameras stacked into a tall image),
    just after the third hit: numpy state and record, with the cameras of
    both packages."""
    frames = request.param
    jcfg = JC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    if frames == 1:
        jcams, tcams = jax_camera(W, H), default_camera(W, H)
        cam_x = jcams
    else:
        jcams = jax_orbit(n_frames=3, aspect_ratio=W / H)
        tcams = orbit_path(n_frames=3, aspect_ratio=W / H)
        cam_x = JCamera(*(jnp.stack([jnp.asarray(getattr(c, f), jnp.float32)
                                       for c in jcams])
                            for f in JCamera._fields))
    n = frames * H * W * KPP
    quota = SPP // KPP
    arrs = dict(
        origin=np.zeros((3, n), np.float32),
        direction=np.tile(np.float32([[0], [0], [1]]), (1, n)),
        time=np.zeros((1, n), np.float32),
        throughput=np.ones((3, n), np.float32),
        radiance_sum=np.zeros((3, n), np.float32),
        depth=np.zeros((1, n), np.int32),
        sample=np.full((1, n), -1, np.int32),
        pixel=np.arange(n, dtype=np.int32)[None],
        path_alive=np.zeros((1, n), bool),
        s_base=(np.arange(n, dtype=np.int32) % KPP * quota)[None],
        s_quota=np.full((1, n), quota, np.int32),
    )
    scene, scfg = jax_scene(), JP.step_cfg(jcfg)
    dims = JP.make_dims(jcfg, W, H, SPP, KPP)
    hit_fn = hit_rows_adapter(jax_hit)
    st = JP.p_respawn_step(cam_x, _jax_state(arrs), np.uint32(SALT),
                           jnp.int32(0), dims, cfg=scfg, n_frames=frames)
    for k in (1, 2):
        rec, st = JP.p_hit_step(scene, st, cfg=jcfg, hit_fn=hit_fn)
        st = JP.p_scatter_respawn_step(scene, cam_x, st, rec, np.uint32(SALT),
                                       jnp.int32(k), dims, cfg=scfg,
                                       n_frames=frames)
    rec, st = JP.p_hit_step(scene, st, cfg=jcfg, hit_fn=hit_fn)
    st_np = {f: np.asarray(getattr(st, f)) for f in JP.PathState._fields}
    rec_np = {f: np.asarray(getattr(rec, f)) for f in HitRecordRows._fields}
    return frames, jcams, cam_x, tcams, st_np, rec_np


def _port_scatter(mid, lean):
    frames, _, _, tcams, st_np, rec_np = mid
    cfg = TC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP,
             **_extra(lean))
    cam_rows = (B.pack_camera(tcams) if frames == 1
                else B.pack_cameras(tcams))
    rec = HitRecordRows(**{f: torch.from_numpy(v.copy())
                           for f, v in rec_np.items()})
    return F.scatter_respawn_plain(cam_rows, _torch_state(st_np), rec, SALT,
                                   3, TP.make_dims(cfg, W, H, SPP, KPP),
                                   cfg=cfg, lean=lean)


def _jax_args(mid, lean):
    frames, jcams, cam_x, _, st_np, rec_np = mid
    jcfg = JC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP,
              **_extra(lean))
    rec = JRec(**{f: jnp.asarray(v) for f, v in rec_np.items()})
    return (jcfg, _jax_state(st_np), rec,
            JP.make_dims(jcfg, W, H, SPP, KPP))


def _flips(ours, ref):
    """(share of lanes whose alive, depth or sample differ; the lanes
    that agree on all three)."""
    same = np.ones(_np(ours.pixel).shape[1], bool)
    for f in ("path_alive", "depth", "sample"):
        same &= (_np(getattr(ours, f)) == _np(getattr(ref, f)))[0]
    return 1.0 - same.mean(), same


@pytest.mark.parametrize("lean", [True, False])
def test_plain_scatter_respawn_matches_reference_step(mid_render, lean):
    """Against p_scatter_respawn_step: the draws bit for bit, the integer
    rows on every lane, and the float rows within f32 round-off (XLA's CPU
    fuses a multiply and an add where the port rounds twice: ROADMAP
    Queue 3)."""
    frames = mid_render[0]
    n = mid_render[4]["pixel"].shape[1]
    for purpose in (0x5CA77E12, 0x2E59A301):
        np.testing.assert_array_equal(
            hash_uniform01((5, n), SALT, 3, purpose).numpy(),
            np.asarray(jax_draws((5, n), np.uint32(SALT), jnp.int32(3),
                                 purpose)))
    jcfg, st_j, rec_j, dims = _jax_args(mid_render, lean)
    ref = JP.p_scatter_respawn_step(jax_scene(), mid_render[2], st_j, rec_j,
                                    np.uint32(SALT), jnp.int32(3), dims,
                                    cfg=JP.step_cfg(jcfg), n_frames=frames,
                                    lean=lean)
    ours = _port_scatter(mid_render, lean)
    for f in ("path_alive", "depth", "sample"):
        np.testing.assert_array_equal(_np(getattr(ours, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    for f in ("origin", "direction", "time", "throughput", "radiance_sum"):
        np.testing.assert_allclose(_np(getattr(ours, f)),
                                   _np(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("lean", [True, False])
def test_plain_scatter_respawn_matches_pallas_kernel_interpret(mid_render,
                                                               lean):
    """Against the TPU scatter+respawn kernel itself (interpret mode).  It
    multiplies by reciprocals where the port divides and takes omc^5 by
    multiplies (scatter_pallas.py:13-22), so a threshold decision may flip
    on a lane whose draw sits within an ulp of it: bounded at 1%, and the
    float rows of the lanes that agree within 1e-4."""
    jcams = mid_render[1]
    jcfg, st_j, rec_j, dims = _jax_args(mid_render, lean)
    ref = scatter_respawn_pallas(jax_scene(), jcams,
                                 st_j, rec_j, np.uint32(SALT), jnp.int32(3),
                                 dims, cfg=JP.step_cfg(jcfg), ray_block=RB,
                                 interpret=True, lean=lean)
    ours = _port_scatter(mid_render, lean)
    flips, same = _flips(ours, ref)
    assert flips < 0.01, flips
    for f in ("origin", "direction", "time", "throughput"):
        np.testing.assert_allclose(_np(getattr(ours, f))[:, same],
                                   _np(getattr(ref, f))[:, same],
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_scatter_wrapper_on_cpu_is_the_plain_step(mid_render):
    frames, _, _, tcams, st_np, rec_np = mid_render
    cfg = TC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    cam_rows = (B.pack_camera(tcams) if frames == 1
                else B.pack_cameras(tcams))
    rec = HitRecordRows(**{f: torch.from_numpy(v.copy())
                           for f, v in rec_np.items()})
    st = _torch_state(st_np)
    args = (cam_rows, st, rec, SALT, 3, TP.make_dims(cfg, W, H, SPP, KPP))
    before = F.LAUNCHES
    a = F.scatter_respawn(*args, cfg=cfg, lean=True)
    b = F.scatter_respawn_plain(*args, cfg=cfg, lean=True)
    assert F.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.radiance_sum is st.radiance_sum     # F never touches radiance
    with pytest.raises(ValueError, match="unsupported device"):
        F.scatter_respawn(cam_rows, st._replace(origin=st.origin.to("meta")),
                          rec, SALT, 3, args[-1], cfg=cfg)


def test_split_bounce_is_the_fused_bounce():
    """Hit + sky then scatter + respawn is the plain fused bounce bit for
    bit (the identity chip_smoke.py holds kernels E then F to against
    kernel B), on one camera and on three."""
    arrs = _random_state(3 * H * W * KPP, seed=24)
    cfg = TC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP,
             **_extra(False))
    dims = TP.make_dims(cfg, W, H, SPP, KPP)
    tab = sphere_table(random_scene())
    for cam_rows in (B.pack_camera(default_camera(W, H)),
                     B.pack_cameras(orbit_path(n_frames=3,
                                               aspect_ratio=W / H))):
        st = _torch_state(arrs)
        rec, mid = E.hit_sky(tab, st, cfg=cfg)
        split = F.scatter_respawn(cam_rows, mid, rec, SALT, 5, dims, cfg=cfg,
                                  lean=False)
        fused = B.bounce(tab, cam_rows, st, SALT, 5, dims, cfg=cfg,
                         lean=False)
        for f in TP.PathState._fields:
            assert torch.equal(getattr(split, f), getattr(fused, f)), f
