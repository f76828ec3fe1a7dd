"""PyTorch port: the persistent scheduler's device-side tails against the
JAX package — ``p_render_until`` (one_shot="staged"), the tail finisher
(one_shot="on"), their renders and conflicts, and the host reads each form
makes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.kernels.dispatch import (
    get_hit_fn_rows_accel as jax_hit_fn_rows_accel)
from win32_raytracer_tpu.scene.builders import test_scene as jax_test_scene
from win32_raytracer_tpu.scene.camera import default_camera as jax_camera
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.kernels.dispatch import get_hit_fn_rows_accel
from win32_raytracer_tpu_torch.scene.builders import get_scene
from win32_raytracer_tpu_torch.scene.camera import default_camera

torch.set_num_threads(1)

W, H, SPP, SALT = 32, 16, 8, 0xBEEF


def _fresh(n, kpp, quota):
    return dict(
        origin=np.zeros((3, n), np.float32),
        direction=np.tile(np.array([[0], [0], [1]], np.float32), (1, n)),
        time=np.zeros((1, n), np.float32),
        throughput=np.ones((3, n), np.float32),
        radiance_sum=np.zeros((3, n), np.float32),
        depth=np.zeros((1, n), np.int32),
        sample=np.full((1, n), -1, np.int32),
        pixel=np.arange(n, dtype=np.int32)[None],
        path_alive=np.zeros((1, n), bool),
        s_base=(np.arange(n) % kpp * quota)[None].astype(np.int32),
        s_quota=np.full((1, n), quota, np.int32),
    )


def _setup():
    """The test scene's first chunk at 32x16, 8 spp (kpp 2, 1,024 lanes)
    after the step-0 respawn, in both packages."""
    cfg_t = TC(width=W, height=H, samples=SPP, seed=4)
    cfg_j = JC(width=W, height=H, samples=SPP, seed=4, backend="jnp")
    kpp = TP._resolve_kpp(cfg_t, SPP)
    quota = SPP // kpp
    arrs = _fresh(W * H * kpp, kpp, quota)
    max_steps = (quota + 1) * (cfg_t.max_depth + 2)

    scene_t, hit_t = get_hit_fn_rows_accel(cfg_t, get_scene("test"),
                                           default_camera(W, H))
    dims_t = TP.make_dims(cfg_t, W, H, SPP, kpp)
    st_t = TP.p_respawn_step(default_camera(W, H), TP.PathState(
        **{k: torch.from_numpy(v.copy()) for k, v in arrs.items()}),
        SALT, 0, dims_t, cfg=cfg_t)
    port = dict(scene=scene_t, cam=default_camera(W, H), dims=dims_t,
                kw=dict(cfg=cfg_t, hit_fn=hit_t), st=st_t)

    scene_j, hit_j = jax_hit_fn_rows_accel(cfg_j, jax_test_scene(), None)
    dims_j = JP.make_dims(cfg_j, W, H, SPP, kpp)
    scfg = JP.step_cfg(cfg_j)
    st_j = JP.p_respawn_step(jax_camera(W, H), JP.PathState(
        **{k: jnp.asarray(v) for k, v in arrs.items()}),
        np.uint32(SALT), jnp.int32(0), dims_j, cfg=scfg)
    ref = dict(scene=scene_j, cam=jax_camera(W, H), dims=dims_j,
               kw=dict(cfg=scfg, hit_fn=hit_j), st=st_j)
    return port, ref, max_steps, W * H * kpp


def _assert_close_states(ours, ref):
    """At most 5% of the lanes differ from the reference's in a field
    beyond rtol = atol = 1e-5 (about 3% do at this size: the packages' hit
    sweeps and camera draws differ in the last bits, which a few lanes'
    scatters amplify), and the alive flags differ on at most 1%."""
    n = ours.pixel.shape[1]
    bad = np.zeros(n, bool)
    for f in TP.PathState._fields:
        a = getattr(ours, f).numpy().astype(np.float64)
        b = np.asarray(getattr(ref, f)).astype(np.float64)
        bad |= ~np.isclose(a, b, rtol=1e-5, atol=1e-5).reshape(-1, n).all(0)
    assert bad.mean() <= 0.05, bad.mean()
    flips = ours.path_alive.numpy() != np.asarray(ref.path_alive)
    assert flips.mean() <= 0.01, flips.mean()


@pytest.mark.parametrize("target_share", [0.5, 0.05, 0.0])
def test_render_until_matches_steps_and_reference(target_share):
    """p_render_until stops at the first bounce whose alive count is <=
    the target (at least one bounce): the same state bit for bit as
    successive p_bounce_step calls, the same step and count, and JAX's
    p_render_until's step and count, its state to f32 round-off."""
    port, ref, max_steps, n = _setup()
    target = int(n * target_share)
    st, step, cnt = TP.p_render_until(
        port["scene"], port["cam"], port["st"], SALT, 0, target,
        port["dims"], max_steps, **port["kw"])
    seq = port["st"]
    for k in range(1, max_steps + 1):
        seq = TP.p_bounce_step(port["scene"], port["cam"], seq, SALT, k,
                               port["dims"], **port["kw"])
        if int(seq.path_alive.sum()) <= target:
            break
    assert (step, cnt) == (k, int(seq.path_alive.sum()))
    for f in TP.PathState._fields:
        assert torch.equal(getattr(st, f), getattr(seq, f)), f
    st_j, step_j, cnt_j = JP.p_render_until(
        ref["scene"], ref["cam"], ref["st"], np.uint32(SALT), jnp.int32(0),
        jnp.int32(target), ref["dims"], jnp.int32(max_steps), **ref["kw"])
    assert (step, cnt) == (int(step_j), int(cnt_j))
    _assert_close_states(st, st_j)


def test_render_until_do_while_and_max_steps():
    """A target the state already meets still runs one bounce; a stage
    stops at max_steps with the count there."""
    port, _, max_steps, n = _setup()
    args = (port["scene"], port["cam"], port["st"], SALT)
    st, step, cnt = TP.p_render_until(*args, 0, n, port["dims"], max_steps,
                                      **port["kw"])
    assert step == 1
    st, step, cnt = TP.p_render_until(*args, 0, -1, port["dims"], 3,
                                      **port["kw"])
    assert step == 3 and cnt == int(st.path_alive.sum())


def test_oneshot_finisher_matches_steps_and_reference():
    """p_render_oneshot from step 2 (the tail finisher's handover) equals
    successive p_bounce_step calls until every lane is dead, bit for bit,
    and JAX's p_render_oneshot to f32 round-off."""
    port, ref, max_steps, _ = _setup()
    st = port["st"]
    st_j = ref["st"]
    for k in (1, 2):
        st = TP.p_bounce_step(port["scene"], port["cam"], st, SALT, k,
                              port["dims"], **port["kw"])
        st_j = JP.p_bounce_step(ref["scene"], ref["cam"], st_j,
                                np.uint32(SALT), jnp.int32(k), ref["dims"],
                                **ref["kw"])
    one = TP.p_render_oneshot(port["scene"], port["cam"], st, SALT, 2,
                              port["dims"], max_steps, **port["kw"])
    seq = st
    for k in range(3, max_steps + 1):
        seq = TP.p_bounce_step(port["scene"], port["cam"], seq, SALT, k,
                               port["dims"], **port["kw"])
        if not bool(seq.path_alive.any()):
            break
    assert not bool(one.path_alive.any())
    for f in TP.PathState._fields:
        assert torch.equal(getattr(one, f), getattr(seq, f)), f
    one_j = JP.p_render_oneshot(ref["scene"], ref["cam"], st_j,
                                np.uint32(SALT), jnp.int32(2), ref["dims"],
                                jnp.int32(max_steps), **ref["kw"])
    _assert_close_states(one, one_j)


def _sq(a):
    return np.sqrt(np.clip(a, 0, 1))


@pytest.mark.parametrize("form", ["chunk", "handover"])
@pytest.mark.parametrize("mode", ["on", "staged"])
def test_one_shot_renders(mode, form, monkeypatch):
    """one_shot "on" or "staged" against "off" and against the JAX render
    with the same knob, statistically (the tails re-key lane draws at their
    own events): mean |diff| of the gamma-2 images < 0.03, the reference's
    bound.  "chunk": 64x32 at 16 spp, 8 lanes a pixel, a 16,384-lane chunk
    at or below the floor, run whole by the knob's form.  "handover": the
    floor lowered to 16,384 lanes in both packages and 64x64 at 64 spp, so
    that the 32,768-lane chunk compacts above the floor in the host loop,
    which hands its tail to the finisher or the stages (an alive check
    every 2 bounces, so that the tail is handed over before it ends)."""
    kw = dict(width=64, height=32, samples=16, seed=6, lanes_per_pixel=8)
    if form == "handover":
        kw.update(height=64, samples=64, check_period=2)
        monkeypatch.setattr(TP, "_COMPACT_FLOOR", 1 << 14)
        monkeypatch.setattr(JP, "_COMPACT_FLOOR", 1 << 14)
    calls = []
    name = "p_render_until" if mode == "staged" else "p_render_oneshot"
    real = getattr(TP, name)
    monkeypatch.setattr(TP, name,
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    scene = get_scene("test")
    got = TP.render_image_persistent(scene, None, TC(one_shot=mode, **kw))
    assert calls, f"{name} did not run"
    assert (calls[0] > 0) == (form == "handover")  # the first stage's step0
    off = TP.render_image_persistent(scene, None, TC(one_shot="off", **kw))
    ref = np.asarray(JP.render_image_persistent(
        jax_test_scene(), None, JC(backend="jnp", one_shot=mode, **kw)))
    got = got.numpy()
    assert got.shape == (kw["height"], 64, 3) and np.isfinite(got).all()
    assert np.abs(_sq(got) - _sq(off.numpy())).mean() < 0.03
    assert np.abs(_sq(got) - _sq(ref)).mean() < 0.03


@pytest.mark.parametrize("mode", ["on", "staged"])
def test_one_shot_conflicts_raise(mode):
    """one_shot "on" or "staged" needs bounces with no host step between
    them: ray binning (a mesh on the triangle grid) and the pallas scatter
    raise ValueError, as in the reference; "auto" turns the one shot off
    there.  (The reference's third conflict, tri_rebin, is not ported: it
    raises NotImplementedError naming Queue 1 item 9.)"""
    from win32_raytracer_tpu_torch.scene.builders import mesh_scene
    cfg = TC(width=16, height=8, samples=8, seed=2)
    with pytest.raises(ValueError, match="one_shot.*ray binning"):
        TP.render_image_persistent(mesh_scene(subdivisions=3), None,
                                   cfg.replace(accel="grid", one_shot=mode))
    with pytest.raises(ValueError, match="one_shot.*pallas"):
        TP.render_image_persistent(get_scene("test"), None,
                                   cfg.replace(scatter_backend="pallas",
                                               one_shot=mode))
    with pytest.raises(NotImplementedError, match="item 9"):
        TP.render_image_persistent(mesh_scene(subdivisions=3), None,
                                   cfg.replace(accel="grid", tri_rebin="on",
                                               ray_binning="off",
                                               one_shot=mode))
    img = TP.render_image_persistent(get_scene("test"), None,
                                     cfg.replace(scatter_backend="pallas"))
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("mode", ["off", "on", "staged"])
def test_host_reads_counted(mode, monkeypatch):
    """HOST_READS counts every alive-count read: one per p_render_until
    bounce under "staged" (64x32 at 16 spp, 8 lanes a pixel: a chunk of
    16,384 lanes, staged from its first bounce)."""
    until = []
    real = TP.p_render_until

    def spy(*a, **k):
        before = TP.HOST_READS
        out = real(*a, **k)
        until.append((out[1] - a[4], TP.HOST_READS - before))
        return out
    monkeypatch.setattr(TP, "p_render_until", spy)
    TP.HOST_READS = 0
    TP.render_image_persistent(get_scene("test"), None,
                               TC(width=64, height=32, samples=16, seed=6,
                                  lanes_per_pixel=8, one_shot=mode))
    assert TP.HOST_READS > 0
    assert bool(until) == (mode == "staged")
    for bounces, reads in until:
        assert reads == bounces
