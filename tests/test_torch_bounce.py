"""PyTorch port: the plain bounce (kernel B's reference), compaction and
split against the JAX package.

Kernel B itself (CUDA) is held against this plain bounce on the card by
chip_smoke.py phase 3, with the same bounds as test_fused_bounce_matches_
two_step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.kernels.bounce_pallas import p_bounce_fused
from win32_raytracer_tpu.kernels.hit_pallas_v7 import hit_coeffs
from win32_raytracer_tpu.ops.hit import hit_spheres as jax_hit
from win32_raytracer_tpu.ops.rows import hit_rows_adapter
from win32_raytracer_tpu.scene.builders import random_scene as jax_scene
from win32_raytracer_tpu.scene.camera import default_camera as jax_camera
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.kernels import bounce as B
from win32_raytracer_tpu_torch.ops.hit import sphere_table
from win32_raytracer_tpu_torch.scene.builders import random_scene
from win32_raytracer_tpu_torch.scene.camera import default_camera

torch.set_num_threads(1)

W, H, SPP, KPP, RB = 64, 32, 8, 2, 256
SALT = 0xABC123


def _state_np(n, seed=11, quota=SPP // KPP):
    """tests/test_bounce_fused.py's random state, as numpy arrays."""
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
        s_quota=np.full((1, n), quota, np.int32),
    )


def _both(arrs):
    return (JP.PathState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            TP.PathState(**{k: torch.from_numpy(v.copy())
                            for k, v in arrs.items()}))


def _port_bounce(st, cfg, step, lean):
    dims = TP.make_dims(cfg, W, H, SPP, KPP)
    return B.bounce_plain(sphere_table(random_scene()),
                          B.pack_camera(default_camera(W, H)), st, SALT, step,
                          dims, cfg=cfg, lean=lean)


_FLOAT_ROWS = ("origin", "direction", "time", "throughput", "radiance_sum")


def _close_shares(ours, ref):
    """Per float field, the share of lanes (same alive flag and depth)
    whose rows agree to isclose(rtol=1e-4, atol=1e-4); asserts the alive,
    depth and sample bounds of test_fused_bounce_matches_two_step."""
    al_t = np.asarray(ours.path_alive)[0]
    al_j = np.asarray(ref.path_alive)[0]
    assert (al_t != al_j).mean() < 0.01
    agree = al_t == al_j
    for f in ("depth", "sample"):
        a = np.asarray(getattr(ours, f))[0, agree]
        b = np.asarray(getattr(ref, f))[0, agree]
        assert (a != b).mean() < 0.01, f
    same = agree & (np.asarray(ours.depth)[0] == np.asarray(ref.depth)[0])
    return {f: np.isclose(np.asarray(getattr(ours, f))[:, same],
                          np.asarray(getattr(ref, f))[:, same],
                          rtol=1e-4, atol=1e-4).all(axis=0).mean()
            for f in _FLOAT_ROWS}


def _assert_states_agree(ours, ref):
    """The bounds of test_fused_bounce_matches_two_step."""
    for f, share in _close_shares(ours, ref).items():
        assert share > 0.99, (f, share)


@pytest.mark.parametrize("extra", [
    dict(),
    dict(russian_roulette=True, rr_start_depth=1, stratify=True),
])
def test_plain_bounce_matches_reference_step(extra):
    """Against p_bounce_step with the reference's jnp hit."""
    kw = dict(width=W, height=H, samples=SPP, lanes_per_pixel=KPP, **extra)
    st_j, st_t = _both(_state_np(H * W * KPP))
    ref = JP.p_bounce_step(
        jax_scene(), jax_camera(W, H), st_j, np.uint32(SALT), jnp.int32(4),
        JP.make_dims(JC(**kw), W, H, SPP, KPP), cfg=JP.step_cfg(JC(**kw)),
        hit_fn=hit_rows_adapter(jax_hit))
    lean = not extra
    _assert_states_agree(_port_bounce(st_t, TC(**kw), 4, lean), ref)


def test_plain_bounce_matches_fused_kernel_interpret():
    """Against the TPU fused bounce kernel itself (interpret mode).  Its
    split-bf16 hit moves scattered directions beyond rtol 1e-4 on ~2% of
    these random lanes, for the reference's own exact-hit step too
    (measured 98.0% close, seeds 11-13), so the port is held to the
    alive/depth/sample bounds and to within 0.5% of the share the
    reference's step reaches."""
    kw = dict(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    st_j, st_t = _both(_state_np(H * W * KPP))
    dims = JP.make_dims(JC(**kw), W, H, SPP, KPP)
    fused = p_bounce_fused(hit_coeffs(jax_scene()), jax_camera(W, H), st_j,
                           np.uint32(SALT), jnp.int32(4), dims,
                           cfg=JP.step_cfg(JC(**kw)), ray_block=RB,
                           interpret=True)
    step = JP.p_bounce_step(jax_scene(), jax_camera(W, H), st_j,
                            np.uint32(SALT), jnp.int32(4), dims,
                            cfg=JP.step_cfg(JC(**kw)),
                            hit_fn=hit_rows_adapter(jax_hit))
    ours = _close_shares(_port_bounce(st_t, TC(**kw), 4, True), fused)
    refs = _close_shares(step, fused)
    for f in _FLOAT_ROWS:
        assert ours[f] >= refs[f] - 0.005, (f, ours[f], refs[f])


def test_bounce_wrapper_on_cpu_is_the_plain_bounce():
    _, st = _both(_state_np(1024, seed=13))
    cfg = TC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    dims = TP.make_dims(cfg, W, H, SPP, KPP)
    args = (sphere_table(random_scene()), B.pack_camera(default_camera(W, H)),
            st, SALT, 3, dims)
    before = B.LAUNCHES
    a = B.bounce(*args, cfg=cfg, lean=True)
    b = B.bounce_plain(*args, cfg=cfg, lean=True)
    assert B.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pack_camera_round_trip():
    cam = default_camera(W, H)
    back = B.unpack_camera(B.pack_camera(cam))
    assert B.pack_camera(cam).shape == (B.CAM_ROWS,)
    for x, y in zip(cam, back):
        assert torch.equal(x.reshape(-1), y.reshape(-1))


def test_sample_accounting_exact():
    """Over many bounces every lane advances its sample by at most one and
    never past its quota; split and compaction keep each pixel's quota."""
    cfg = TC(width=W, height=H, samples=SPP, lanes_per_pixel=KPP)
    _, st = _both(_state_np(2048, seed=14))
    for step in range(1, 30):
        nxt = _port_bounce(st, cfg, step, True)
        adv = (nxt.sample - st.sample).numpy()
        assert set(np.unique(adv)) <= {0, 1}
        assert (nxt.sample <= nxt.s_quota - 1).all()
        st = nxt

    def quota_per_pixel(s):
        q = np.zeros(4096, np.int64)
        np.add.at(q, s.pixel.numpy()[0], s.s_quota.numpy()[0])
        return q
    total = quota_per_pixel(st)
    split = TP._split(st)
    np.testing.assert_array_equal(quota_per_pixel(split), total)
    ref = JP._split(JP.PathState(*(jnp.asarray(x.numpy()) for x in st)))
    for f in TP.PathState._fields:
        np.testing.assert_array_equal(getattr(split, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("tail_sorted", [True, False])
def test_compact_matches_reference(tail_sorted):
    arrs = _state_np(4096, seed=15)
    if not tail_sorted:
        arrs["pixel"] = np.random.default_rng(1).permutation(
            arrs["pixel"][0])[None].astype(np.int32)
    alive = int(arrs["path_alive"].sum())
    k_new = 1 << (alive - 1).bit_length()
    st_j, st_t = _both(arrs)
    acc = np.random.default_rng(2).uniform(0, 1, (3, 2048)).astype(np.float32)
    new_t, acc_t = TP._compact(st_t, torch.from_numpy(acc.copy()),
                               k_new=k_new, lanes_per_pixel=KPP,
                               tail_sorted=tail_sorted)
    new_j, acc_j = JP._compact(st_j, jnp.asarray(acc), k_new=k_new,
                               lanes_per_pixel=KPP, tail_sorted=tail_sorted)
    for f in TP.PathState._fields:
        np.testing.assert_array_equal(getattr(new_t, f).numpy(),
                                      np.asarray(getattr(new_j, f)), err_msg=f)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-6)
