"""PyTorch port: the wavefront scheduler (render.py) against the JAX
package's, and its exact regime against the native C++ oracle.

Both packages draw the same threefry numbers (tests/test_torch_threefry.py)
for the same lanes, so on the CPU the port's wavefront images match the
reference's nearly pixel for pixel.  What differs is f32 round-off: XLA's
CPU code fuses the camera's and the Moller-Trumbore multiply-adds, the
ground sphere's root is ill conditioned, and the ball sample takes
u^(1/3) where the reference takes cbrt; a last-place difference can flip
a threshold decision (metal absorb, Schlick reflect) and move that one
path.  Each test states its bound and what was measured when the test
was written; a bound sits a few pixels' worth above the measurement."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from win32_raytracer_tpu import oracle
from win32_raytracer_tpu.animation import render_animation as jax_animation
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.kernels.dispatch import get_hit_fn as jax_get_hit_fn
from win32_raytracer_tpu.render import hit_step as jax_hit_step
from win32_raytracer_tpu.render import make_primary_rays as jax_primary
from win32_raytracer_tpu.render import render as jax_render
from win32_raytracer_tpu.render import render_image as jax_render_image
from win32_raytracer_tpu.render import scatter_step as jax_scatter_step
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu.scene.camera import default_camera as jax_default_camera
from win32_raytracer_tpu.scene.camera import make_camera as jax_make_camera
from win32_raytracer_tpu.scene.spheres import SceneBuilder as JBuilder
from win32_raytracer_tpu_torch.animation import orbit_path, render_animation
from win32_raytracer_tpu_torch.api import render as api_render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.core import rng
from win32_raytracer_tpu_torch.kernels.dispatch import get_hit_fn, hit_tables
from win32_raytracer_tpu_torch.ops.hit import HitRecord, hit_spheres
from win32_raytracer_tpu_torch.render import (
    WavefrontState, accumulate_pixels, hit_step, make_primary_rays, render,
    render_image, scatter_step, tonemap, trace)
from win32_raytracer_tpu_torch.scene import builders as tb
from win32_raytracer_tpu_torch.scene.camera import default_camera, make_camera
from win32_raytracer_tpu_torch.scene.spheres import SceneBuilder
from win32_raytracer_tpu_torch.utils.progress import stderr_progress

torch.set_num_threads(1)

EPS = 2.0 ** -24


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


def _to_torch_state(js) -> WavefrontState:
    return WavefrontState(*(torch.from_numpy(np.array(x)) for x in js))


@pytest.mark.parametrize("deterministic", [True, False])
def test_make_primary_rays(deterministic):
    """Rows 14-20 of a 48x32 image at 3 spp.  The port's rays equal a
    numpy f32 evaluation of the reference's formula, each operation
    rounded, exactly (deterministic, through a pinhole camera); against
    the JAX package, whose CPU code fuses multiply-adds: the draws, times
    and state rows exactly, origins and directions within 2 f32 epsilons
    of their scale."""
    w, h, spp, rows, y0 = 48, 32, 3, 7, 14
    n = rows * w * spp
    kw = dict(width=w, height=h, samples=spp, deterministic=deterministic)
    key = rng.fold_in(rng.prng_key(3), 1)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    sizes = dict(width=w, height=h, spp=spp, rows=rows)
    ours = make_primary_rays(default_camera(w, h), y0, key, cfg=TC(**kw), **sizes)
    ref = jax_primary(jax_default_camera(w, h), jnp.int32(y0), jkey,
                      cfg=JC(**kw), **sizes)
    for f in ("time", "throughput", "radiance", "alive"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    cam = default_camera(w, h)
    scale = (cam.origin.abs().max() + cam.lower_left_corner.abs().max()
             + cam.horizontal.abs().max() + cam.vertical.abs().max()).item()
    for f in ("origin", "direction"):
        diff = np.abs(getattr(ours, f).numpy() - np.asarray(getattr(ref, f)))
        assert diff.max() <= 2 * EPS * scale, (f, diff.max())
    assert ours.direction.shape == (n, 3) and ours.origin.is_contiguous()

    if deterministic:
        pin = make_camera((0.0, 1.0, 4.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0),
                          45.0, w / h, 0.0, 4.0)
        got = make_primary_rays(pin, y0, key, cfg=TC(**kw), **sizes)
        f32 = np.float32
        lane = np.arange(n)
        y, x = y0 + lane // (w * spp), (lane // spp) % w
        u = (x.astype(f32) + f32(0.5)) / f32(w)
        v = ((h - y).astype(f32) + f32(0.5)) / f32(h)
        c = {k: getattr(pin, k).numpy() for k in pin._fields}
        o = np.broadcast_to(c["origin"], (n, 3))
        d = (c["lower_left_corner"] + u[:, None] * c["horizontal"]
             + v[:, None] * c["vertical"]) - o
        np.testing.assert_array_equal(got.origin.numpy(), o)
        np.testing.assert_array_equal(got.direction.numpy(), d)
        np.testing.assert_array_equal(got.time.numpy(), np.zeros(n, f32))


@pytest.mark.parametrize("roulette", [False, True])
def test_one_bounce_matches_reference(roulette):
    """One hit_step and one scatter_step of both packages on the same
    primary state (the final scene, 48x32 at 2 spp, the reference's own
    rays); with roulette the step is at its start depth.  hit_step: the
    same winners and sky radiance within 1e-6 (the records' t, point and
    normal round differently on the ill-conditioned roots;
    tests/test_torch_hit_cols.py holds them to the float64 root).
    scatter_step, fed the reference's record: alive flags and the new
    rays and throughput within rtol 1e-4 + atol 1e-5 on all but 0.2% of
    the lanes (measured 0)."""
    w, h, spp = 48, 32, 2
    kw = dict(width=w, height=h, samples=spp, russian_roulette=roulette,
              rr_start_depth=3)
    depth = 3 if roulette else 0
    js = jax_primary(jax_default_camera(w, h), jnp.int32(0),
                     jax.random.PRNGKey(1), cfg=JC(**kw), width=w, height=h,
                     spp=spp, rows=h)
    jscene = jb.random_scene()
    jrec, jst = jax_hit_step(jscene, js, cfg=JC(**kw),
                             hit_fn=jax_get_hit_fn(JC(**kw), jscene))
    jnext = jax_scatter_step(jscene, jst, jrec, jax.random.PRNGKey(2),
                             jnp.int32(depth), cfg=JC(**kw))

    tscene = tb.random_scene()
    rec, st = hit_step(hit_tables(tscene), _to_torch_state(js), cfg=TC(**kw),
                       hit_fn=get_hit_fn(TC(**kw), "cpu", tscene))
    for f in ("hit", "idx", "mat_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), err_msg=f)
    np.testing.assert_allclose(st.radiance.numpy(), np.asarray(jst.radiance),
                               rtol=0, atol=1e-6)

    jrec_t = HitRecord(*(torch.from_numpy(np.array(x)) for x in jrec))
    nxt = scatter_step(tscene, _to_torch_state(jst), jrec_t, rng.prng_key(2),
                       depth, cfg=TC(**kw))
    off = nxt.alive.numpy() != np.asarray(jnext.alive)
    for f in ("origin", "direction", "throughput", "radiance"):
        a, b = getattr(nxt, f).numpy(), np.asarray(getattr(jnext, f))
        off |= ~np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=1)
    assert off.mean() <= 0.002, off.sum()
    np.testing.assert_array_equal(nxt.time.numpy(), np.asarray(jnext.time))
    if roulette:
        died = np.asarray(jst.alive) & np.asarray(jrec.hit) & ~nxt.alive.numpy()
        assert died.any()


def test_render_image_partial_last_chunk_and_progress():
    """rays_per_chunk gives 5-row chunks of a 27-row image: five whole
    chunks and a sixth traced whole and cut to 2 rows; the chunk keys fold
    each chunk's first row.  Against the reference's render_image, and
    the progress events."""
    w, h, spp = 40, 27, 3
    kw = dict(width=w, height=h, samples=spp, seed=4, rays_per_chunk=w * spp * 5)
    events = []
    ours = render_image(tb.test_scene(), default_camera(w, h), TC(**kw),
                        progress=events.append)
    ref = np.asarray(jax_render_image(jb.test_scene(), jax_default_camera(w, h),
                                      JC(**kw)))
    assert ours.shape == (h, w, 3)
    close = np.isclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5).all(axis=2)
    assert close.mean() >= 0.99, close.mean()
    kinds = [e["kind"] for e in events]
    assert kinds == ["chunk"] * 6 + ["done"]
    assert [e["rows_done"] for e in events[:-1]] == [5, 10, 15, 20, 25, 27]
    assert all(e["rows_total"] == h and e["mrays_per_sec"] > 0 for e in events[:-1])


def test_progress_printer(capsys):
    stderr_progress({"kind": "chunk", "rows_done": 5, "rows_total": 20,
                     "elapsed_s": 0.5, "mrays_per_sec": 1.25})
    stderr_progress({"kind": "done", "elapsed_s": 2.0, "mrays_per_sec": 3.5})
    err = capsys.readouterr().err.splitlines()
    assert err == ["[wrt] rows 5/20 (25%) elapsed 0.5s ~1.25 Mrays/s",
                   "[wrt] done in 2.0s (3.50 Mrays/s primary)"]


# (scene, extra knobs) -> (max mean |diff| u8, min pearson r).  Measured:
# final 4 spp 0.0087 / 0.999993, final with roulette 0.0169 / 0.99995,
# mesh 0.0 / 1.0 (identical), test 7 spp 0.0002 / 0.99999998.
STAT = {
    ("final", "4 spp"): (dict(samples=4, seed=5), (0.05, 0.9995)),
    ("final", "roulette"): (dict(samples=4, seed=6, russian_roulette=True,
                                 rr_start_depth=1), (0.1, 0.999)),
    ("mesh", "2 spp"): (dict(samples=2, seed=7), (0.05, 0.9995)),
    ("test", "7 spp"): (dict(samples=7, seed=8), (0.05, 0.9995)),
}


@pytest.mark.parametrize("scene,label", sorted(STAT))
def test_render_matches_reference(scene, label):
    """48x32 renders through render.render (the auto scheduler picks the
    wavefront below 8 spp), the composite mesh scene included."""
    kw, (max_d, min_r) = STAT[(scene, label)]
    kw = dict(width=48, height=32, **kw)
    ours = render(tb.get_scene(scene), cfg=TC(**kw))
    ref = jax_render(jb.get_scene(scene), cfg=JC(**kw))
    assert ours.shape == ref.shape == (32, 48, 3) and ours.dtype == np.uint8
    d, r = _stats(ours, ref)
    assert d <= max_d and r >= min_r, (d, r)


def test_entry_points_take_the_wavefront():
    """Deterministic renders at any spp and scheduler="wavefront" run the
    wavefront through api.render; an explicit hit_fn is called on the
    scene as given; on the persistent scheduler it is adapted to rows and
    gives the default route's image."""
    base = dict(width=16, height=8, seed=2)
    det = api_render("test", cfg=TC(samples=8, deterministic=True, **base),
                     device="cpu")
    same = render(tb.test_scene(), cfg=TC(samples=1, deterministic=True, **base))
    np.testing.assert_array_equal(det.image, same)   # every draw is 0.5
    wf = api_render("test", cfg=TC(samples=16, scheduler="wavefront", **base),
                    device="cpu")
    assert wf.image.shape == (8, 16, 3) and wf.image.std() > 0

    calls = []

    def spy(scene, o, d, t, min_t=0.001):
        calls.append(o.shape[0])
        return hit_spheres(scene, o, d, t, min_t=min_t)
    cfg = TC(samples=2, max_depth=3, **base)
    img = render(tb.test_scene(), cfg=cfg, hit_fn=spy)
    assert calls == [16 * 8 * 2] * 4
    np.testing.assert_array_equal(img, render(tb.test_scene(), cfg=cfg))
    calls.clear()
    cfg = TC(samples=8, **base)
    img = render(tb.test_scene(), cfg=cfg, hit_fn=spy)
    assert calls and all(n >= 16 * 8 for n in calls)   # persistent lanes
    np.testing.assert_array_equal(img, render(tb.test_scene(), cfg=cfg))


def test_trace_and_accumulate():
    """trace runs max_depth + 1 bounces from given rays; accumulate_pixels
    is the sample mean (the samples added in order, then one true
    division)."""
    w, h, spp = 8, 4, 3
    st = make_primary_rays(default_camera(w, h), 0, rng.prng_key(0), cfg=TC(),
                           width=w, height=h, spp=spp, rows=h)
    rad = trace(tb.test_scene(), st.origin, st.direction, st.time,
                rng.prng_key(5), TC(max_depth=4))
    assert rad.shape == (w * h * spp, 3) and (rad >= 0).all()
    acc = accumulate_pixels(rad, width=w, spp=spp, rows=h)
    r = rad.reshape(h, w, spp, 3)
    want = ((r[:, :, 0] + r[:, :, 1]) + r[:, :, 2]) / torch.tensor(3.0)
    assert torch.equal(acc, want)
    assert torch.equal(tonemap(acc), tonemap(want))


def test_render_animation_on_the_wavefront(tmp_path):
    """Two frames at 2 spp render frame by frame through api.render (the
    reference's batch_frames=1 arm) and match the reference's frames
    (measured: identical)."""
    w, h = 32, 24
    cfg = dict(width=w, height=h, samples=2, seed=3)
    pattern = str(tmp_path / "f_%02d.png")
    got = []
    ours = render_animation("test", orbit_path(n_frames=2, aspect_ratio=w / h),
                            TC(**cfg), out_pattern=pattern, device="cpu",
                            frame_callback=lambda i, img, ms: got.append(i))
    from win32_raytracer_tpu.animation import orbit_path as jax_orbit
    ref = jax_animation(jb.test_scene(), jax_orbit(n_frames=2, aspect_ratio=w / h),
                        JC(**cfg))
    assert got == [0, 1] and (tmp_path / "f_01.png").exists()
    for a, b in zip(ours, ref):
        d, r = _stats(a, np.asarray(b))
        assert d <= 0.05 and r >= 0.9995, (d, r)


def _specular(builder):
    """tests/test_golden.py's metal + dielectric scene."""
    b = builder()
    b.add_metal((0.0, 0.3, 0.0), 0.8, (0.9, 0.8, 0.7), 0.0)
    b.add_metal((-1.8, 0.2, -0.5), 0.6, (0.6, 0.7, 0.9), 0.0)
    b.add_dielectric((1.7, 0.3, 0.5), 0.6, 1.5)
    b.add_dielectric((1.7, 0.3, 0.5), -0.5, 1.5)  # hollow shell
    return b.build()


def _sky_only(builder):
    b = builder()
    b.add_metal((0.0, -500.0, 0.0), 1.0, (1, 1, 1), 0.0)
    return b.build()


GOLDEN = {
    "quirks": (_specular, dict(width=96, height=64, reflect_thres=2.0)),
    "textbook": (_specular, dict(width=96, height=64, reflect_thres=2.0,
                                 refract_discriminant_bias=1.0,
                                 schlick_uses_ni_over_nt=False)),
    "sky only": (_sky_only, dict(width=64, height=48)),
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_exact_regime_matches_native_oracle(case):
    """tests/test_golden.py's exact regime on the port: deterministic
    specular scenes at 1 spp through a pinhole camera, against the native
    C++ oracle within that file's tolerances (mean |diff| < 0.5 u8, fewer
    than 1% of pixels off by more than 3; the sky-only scene exactly).
    Measured: 0 pixels differ in all three."""
    if not oracle.available():
        pytest.skip("native oracle not built")
    build, kw = GOLDEN[case]
    kw = dict(samples=1, deterministic=True, **kw)
    look = ((0.0, 1.0, 4.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0))
    aspect = kw["width"] / kw["height"]
    ours = render(build(SceneBuilder), make_camera(*look, 45.0, aspect, 0.0, 4.0),
                  TC(**kw))
    ref = oracle.oracle_render(build(JBuilder), *look, 45.0, 0.0, 4.0, JC(**kw),
                               deterministic=True)
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 0.5, diff.mean()
    assert (diff > 3).mean() < 0.01
    if case == "sky only":
        np.testing.assert_array_equal(ours, ref)
    # The JAX package's own render of the same scene, for the record.
    jref = jax_render(build(JBuilder), jax_make_camera(*look, 45.0, aspect, 0.0, 4.0),
                      JC(**kw))
    assert np.abs(ours.astype(int) - jref.astype(int)).mean() < 0.5
