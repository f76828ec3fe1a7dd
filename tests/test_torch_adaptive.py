"""PyTorch port: difficulty-adaptive lane allocation (adaptive.py and the
adaptive arm of persistent.render_image_persistent) against the JAX
package.

Tolerances.  ``alloc_lanes``: its invariants exactly, and its arrays equal
to the JAX function's on the reference's parameter grid (``cumsum_f32``
adds in XLA's CPU order, bit for bit).  At chunk sizes the weights'
normalising sums add in other orders, so a few boundaries move by one lane
(COUNTS_MOVED_MAX); at 96,000 pixels the reference can give a pixel no
lane, which the port's running max prevents.  ``_pool_est``: within POW_ULPS of the JAX function's,
the libraries' powers differing.  Renders:
statistically, as the JAX package's own tests hold them (mean |diff| of the
square-rooted images under 0.035), and bit for bit run to run; against the
JAX package's adaptive render, ADAPTIVE_BOUNDS.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.adaptive import alloc_lanes as jax_alloc
from win32_raytracer_tpu.api import render as jax_render
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.adaptive import alloc_lanes, cumsum_f32
from win32_raytracer_tpu_torch.animation import orbit_path
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.render import render_image
from win32_raytracer_tpu_torch.scene import builders as tb

torch.set_num_threads(1)


def _check_invariants(pixel, s_base, s_quota, *, P, L, spp_done, spp,
                      q_rest=None):
    """tests/test_adaptive.py's invariants, vectorised: ascending,
    contiguous per pixel, every pixel present; each pixel's lanes partition
    its remaining samples (its first lane starts at spp_done, each next
    lane where the one before ends, its last ends at spp_done + q_rest)."""
    pixel, s_base, s_quota = (np.asarray(a)[0] for a in (pixel, s_base, s_quota))
    assert pixel.shape == (L,)
    step = np.diff(pixel)
    assert ((step == 0) | (step == 1)).all() and pixel[0] == 0
    assert pixel[-1] == P - 1                  # every pixel present
    first = np.r_[True, step != 0]
    last = np.r_[step != 0, True]
    end = s_base + s_quota
    want_end = spp if q_rest is None else spp_done + np.asarray(q_rest)[pixel]
    assert (s_quota >= 0).all()
    assert (s_base[first] == spp_done).all()
    assert (s_base[1:][~first[1:]] == end[:-1][~first[1:]]).all()
    assert (end[last] == (want_end if q_rest is None else want_end[last])).all()


def _both(est, **kw):
    """(port arrays, JAX arrays, boundaries that differ)."""
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ours = [x.numpy() for x in alloc_lanes(torch.from_numpy(est), **tkw)]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref = [np.asarray(x) for x in jax_alloc(jnp.asarray(est), **jkw)]
    for x in ours:
        assert x.dtype == np.int32 and x.shape == (1, kw["n_lanes"])
    p = est.shape[0]
    counts = [np.bincount(a[0] if "pixel_ids" not in kw else
                          np.searchsorted(kw["pixel_ids"], a[0]),
                          minlength=p) for a in (ours[0], ref[0])]
    moved = int((np.cumsum(counts[0]) != np.cumsum(counts[1])).sum())
    return ours, ref, moved


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("P,L,spp_done,spp,kmax", [
    (64, 256, 4, 100, 32),
    (64, 64, 0, 7, 4),        # budget == floor: every pixel gets 1
    (10, 173, 2, 10, 8),      # prime-ish budget, few samples left
])
def test_alloc_matches_reference(seed, P, L, spp_done, spp, kmax):
    rng = np.random.default_rng(seed)
    est = rng.uniform(1.0, 11.0, P).astype(np.float32)
    ours, ref, moved = _both(est, n_lanes=L, spp_done=spp_done, spp=spp,
                             kpp_max=kmax)
    _check_invariants(*ours, P=P, L=L, spp_done=spp_done, spp=spp)
    assert moved == 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


# Pixels whose lane count may differ from the reference's at 4,800 pixels:
# the weights' normalising sums add in other orders in XLA and torch (an ulp
# apart now and then), which moves a rounding boundary by one lane.
# Measured when the test was written: 4 and 4 pixels (float estimates,
# seeds 0 and 3), 0 and 0 (integer estimates).
COUNTS_MOVED_MAX = 8


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("seed", [0, 3])
def test_alloc_at_a_chunk_size(seed, kind):
    """4,800 pixels (a 64 x 75 chunk at 4 lanes a pixel, padded): the
    invariants exactly; against the JAX function each pixel's lane count
    within one lane, and few of them moved."""
    P, L = 4800, 19660
    rng = np.random.default_rng(seed)
    est = (rng.uniform(1.0, 11.0, P).astype(np.float32) if kind == "float"
           else rng.integers(0, 50, P).astype(np.int32))
    ours, ref, _ = _both(est, n_lanes=L, spp_done=4, spp=100, kpp_max=32)
    _check_invariants(*ours, P=P, L=L, spp_done=4, spp=100)
    counts = [np.bincount(a[0][0], minlength=P) for a in (ours, ref)]
    assert np.abs(counts[0] - counts[1]).max() <= 1
    assert (counts[0] != counts[1]).sum() <= COUNTS_MOVED_MAX


@pytest.mark.parametrize("n", [5, 16, 17, 4800, 96001])
def test_cumsum_f32_is_xla_cumsum(n):
    """The blocked scan reproduces XLA's CPU cumsum bit for bit, in adds of
    fixed order (so a card repeats it)."""
    x = np.random.default_rng(n).uniform(0, 1, n).astype(np.float32)
    ours = cumsum_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jnp.cumsum(jnp.asarray(x))))


def test_alloc_keeps_a_lane_for_every_pixel_at_scale():
    """96,000 pixels with integer estimates, a quarter of them 0 (as sky
    pixels' are).  The blocked scan steps down by an ulp where a zero weight
    follows a block's end, and the reference's boundaries then give a pixel
    no lane: 8 pixels here, whose remaining samples never run.  The port's
    running max keeps every invariant, and its lane counts differ from the
    reference's only there: each dropped pixel gets its lane back from its
    neighbour."""
    P, L = 96000, 393216
    est = np.random.default_rng(1).integers(0, 50, P).astype(np.int32)
    est[::4] = 0
    ours, ref, _ = _both(est, n_lanes=L, spp_done=4, spp=100, kpp_max=32)
    _check_invariants(*ours, P=P, L=L, spp_done=4, spp=100)
    counts = [np.bincount(a[0][0], minlength=P) for a in (ours, ref)]
    dropped = int((counts[1] == 0).sum())
    assert dropped == 8 and counts[0].min() >= 1
    assert np.abs(counts[0] - counts[1]).max() == 1
    assert (counts[0] != counts[1]).sum() == 2 * dropped


def test_alloc_monotone_in_difficulty():
    """A 10x harder pixel gets more than twice the lanes of an easy one,
    and a smaller quota a lane; as the reference's."""
    P, L = 128, 512
    est = np.ones(P, np.float32)
    est[7] = 10.0
    ours, ref, moved = _both(est, n_lanes=L, spp_done=4, spp=100, kpp_max=32)
    pixel, s_quota = ours[0][0], ours[2][0]
    counts = np.bincount(pixel, minlength=P)
    assert counts[7] > counts[3] * 2
    assert s_quota[pixel == 7].max() < s_quota[pixel == 3].min()
    assert moved == 0 and all(np.array_equal(a, b) for a, b in zip(ours, ref))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_alloc_extreme_skew_keeps_floor(dtype):
    """One pixel with all the difficulty does not starve the others (and an
    int32 estimate, as the prepass gives, is taken as it is)."""
    P, L = 32, 96
    est = np.full(P, 1e-3 if dtype == np.float32 else 0, dtype)
    est[0] = 10 ** 6
    ours, ref, moved = _both(est, n_lanes=L, spp_done=0, spp=16, kpp_max=16)
    _check_invariants(*ours, P=P, L=L, spp_done=0, spp=16)
    assert np.bincount(ours[0][0], minlength=P).min() >= 1
    assert moved == 0 and all(np.array_equal(a, b) for a, b in zip(ours, ref))


def test_alloc_pixel_ids_and_q_rest():
    """The sharded scheduler's arguments: its own pixel ids and per-pixel
    remaining samples (0 = a pixel whose lanes never run)."""
    rng = np.random.default_rng(5)
    P, L = 40, 160
    est = rng.uniform(0, 9, P).astype(np.float32)
    ids = (np.arange(P) * 3 + 7).astype(np.int32)
    q = rng.integers(0, 12, P).astype(np.int32)
    ours, ref, moved = _both(est, n_lanes=L, spp_done=4, spp=16, kpp_max=8,
                             pixel_ids=ids, q_rest=q)
    assert moved == 0 and all(np.array_equal(a, b) for a, b in zip(ours, ref))
    pix = ours[0][0]
    assert set(np.unique(pix)) == set(ids)
    _check_invariants(np.searchsorted(ids, pix)[None], ours[1], ours[2],
                      P=P, L=L, spp_done=4, spp=16, q_rest=q)


def test_alloc_refuses_fewer_lanes_than_pixels():
    with pytest.raises(ValueError, match="lanes"):
        alloc_lanes(torch.ones(8), n_lanes=4, spp_done=1, spp=4)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("h,w", [(3, 5), (16, 24)])
def test_pool_est_matches_reference(h, w):
    """The box and the max are the reference's adds and division; the power
    is each library's, so the two agree within POW_ULPS."""
    rng = np.random.default_rng(h)
    est = rng.integers(0, 60, h * w).astype(np.int32)
    ours = TP._pool_est(torch.from_numpy(est), h, w).numpy()
    ref = np.asarray(JP._pool_est(jnp.asarray(est), h, w))
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (h * w,)
    assert _ulps(ours, ref).max() <= POW_ULPS, _ulps(ours, ref).max()


# XLA's CPU power against torch's: 3 ulps measured when the test was written
# (torch's own CPU power rounds the 1.2 exponent to f32 in its vector path
# and not for short rows, itself a few ulps apart).
POW_ULPS = 4


def _sq(x):
    return np.sqrt(np.clip(x, 0, 1))


def test_adaptive_render_matches_uniform():
    """The adaptive two-phase render against the uniform persistent render
    (other draws, so statistically), and bit for bit run to run."""
    cfg = TC(width=64, height=48, samples=16, seed=5, scheduler="persistent")
    base = TP.render_image_persistent(tb.test_scene(), None, cfg).numpy()
    cfg_a = cfg.replace(adaptive_alloc="on")
    img = TP.render_image_persistent(tb.test_scene(), None, cfg_a).numpy()
    img2 = TP.render_image_persistent(tb.test_scene(), None, cfg_a).numpy()
    assert np.array_equal(img, img2), "adaptive render not deterministic"
    assert img.shape == base.shape == (48, 64, 3)
    d = np.abs(_sq(img) - _sq(base)).mean()
    assert d < 0.035, d


def test_adaptive_guard_raises():
    """adaptive_alloc="on" needs an unbinned render with kpp > 1 and
    spp > kpp (here spp == kpp); an unknown adaptive_pool value raises."""
    cfg = TC(width=8, height=8, samples=4, adaptive_alloc="on",
             lanes_per_pixel=4)
    with pytest.raises(ValueError, match="adaptive_alloc"):
        TP.render_image_persistent(tb.test_scene(), None, cfg)
    with pytest.raises(ValueError, match="adaptive_pool"):
        TP.render_image_persistent(tb.test_scene(), None, cfg.replace(
            samples=8, adaptive_pool="ON"))


def test_adaptive_multiframe_matches():
    """Adaptive allocation over a multi-frame batch (a tall virtual image)
    against the uniform batch, statistically."""
    cfg = TC(width=48, height=32, samples=16, scheduler="persistent", seed=3)
    cams = orbit_path(n_frames=2, radius=12.0,
                      aspect_ratio=cfg.width / cfg.height)
    base = TP.render_image_persistent(tb.test_scene(), cams, cfg).numpy()
    imgs = TP.render_image_persistent(
        tb.test_scene(), cams, cfg.replace(adaptive_alloc="on")).numpy()
    assert imgs.shape == base.shape == (2, 32, 48, 3)
    d = np.abs(_sq(imgs) - _sq(base)).mean()
    assert d < 0.04, d


def test_adaptive_pool_render_statistics():
    """adaptive_pool="on" changes the allocation only: the render against
    the uniform wavefront image, statistically."""
    cfg = TC(width=48, height=24, samples=32, seed=4, adaptive_alloc="on",
             adaptive_pool="on")
    lin = TP.render_image_persistent(tb.test_scene(), None, cfg).numpy()
    lin_w = render_image(tb.test_scene(), None, cfg.replace(
        adaptive_alloc="off", adaptive_pool="auto")).numpy()
    assert np.isfinite(lin).all()
    assert np.abs(lin - lin_w).mean() < 0.03


# Mean |diff| in u8 and Pearson r of the port's adaptive render against the
# JAX package's (test scene, 64x48, 16 spp, seed 5), about 2x the values
# measured when the test was written: pool "off" 0.0467 / 0.99995, "on"
# 0.259 / 0.99973.  Both packages draw the same numbers for the same lanes,
# but a last-place path flip in the prepass (XLA's CPU code fuses
# multiply-adds, torch rounds each) changes a pixel's estimate (2 of 3,072
# at "on"), the allocation around it and with it the draws of every later
# lane: the images agree statistically, as binned renders do.
ADAPTIVE_BOUNDS = {"off": (0.1, 0.9999), "on": (0.52, 0.9994)}


@pytest.mark.parametrize("pool", sorted(ADAPTIVE_BOUNDS))
def test_adaptive_render_matches_reference(pool):
    kw = dict(width=64, height=48, samples=16, seed=5, scheduler="persistent",
              adaptive_alloc="on", adaptive_pool=pool)
    ref = jax_render(jb.test_scene(), cfg=JC(backend="jnp", **kw)).image
    ours = render(tb.test_scene(), cfg=TC(**kw), device="cpu").image
    a, b = ours.astype(np.float64), ref.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    d = float(np.abs(a - b).mean())
    max_d, min_r = ADAPTIVE_BOUNDS[pool]
    assert d <= max_d and r >= min_r, (d, r)
