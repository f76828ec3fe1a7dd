"""PyTorch port: the persistent scheduler's compaction engines and flushes
against the JAX package — the route compactor (compactor="route"), the
window flush (flush_mode="window"), receiver redistribution
(redistribute="on") and the run-sum flush every flush goes through.

The same numpy inputs go through both packages.  Lane placement and every
integer field are compared bit for bit; accumulators, whose adds run in
another order in each package, to f32 summation order (rtol and atol
2e-6, the reference's bound for its window flush)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.render import render_image as jax_render_image
from win32_raytracer_tpu.scene.builders import test_scene as jax_test_scene
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.scene.builders import test_scene as port_scene

torch.set_num_threads(1)

RTOL = ATOL = 2e-6


def _state_np(n, alive, pix, seed):
    rng = np.random.default_rng(seed)
    return dict(
        origin=rng.normal(0, 1, (3, n)).astype(np.float32),
        direction=rng.normal(0, 1, (3, n)).astype(np.float32),
        time=rng.uniform(0, 1, (1, n)).astype(np.float32),
        throughput=rng.uniform(0, 1, (3, n)).astype(np.float32),
        radiance_sum=rng.uniform(0, 1, (3, n)).astype(np.float32),
        depth=rng.integers(0, 9, (1, n)).astype(np.int32),
        sample=rng.integers(0, 4, (1, n)).astype(np.int32),
        pixel=pix.astype(np.int32)[None],
        path_alive=alive[None],
        s_base=rng.integers(0, 1 << 20, (1, n)).astype(np.int32),
        s_quota=rng.integers(1, 5, (1, n)).astype(np.int32),
    )


def _both(arrs):
    return (JP.PathState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            TP.PathState(**{k: torch.from_numpy(v.copy())
                            for k, v in arrs.items()}))


def _assert_states_equal(ours, ref, what=""):
    for f in TP.PathState._fields:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{f} {what}")


def _alive(kind, n, rng):
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "all":
        return np.ones(n, bool)
    return rng.uniform(size=n) < 0.4


@pytest.mark.parametrize("n", [4096, 5000])
@pytest.mark.parametrize("kind", ["none", "all", "random"])
@pytest.mark.parametrize("k_rule", ["n", "pow2"])
def test_route_head_matches_reference(n, kind, k_rule):
    """The route compactor's [k_new] head equals JAX's
    _compact_route_core's bit for bit in every field (alive lanes in
    order, the retained dead lanes as inert padding with their pixel and
    radiance), on pixel-lane ids up to 2^29 - 1 in any order; the dropped
    lanes are the dead ones after the head, in order."""
    rng = np.random.default_rng(n + len(kind))
    alive = _alive(kind, n, rng)
    pix = rng.integers(0, 1 << 29, n)
    pix[rng.integers(0, n)] = (1 << 29) - 1
    n_alive = int(alive.sum())
    k_new = n if k_rule == "n" else min(n, TP._next_pow2(n_alive))
    st_j, st_t = _both(_state_np(n, alive, pix, seed=3))
    # An accumulator of one pixel: JAX's segment_sum drops the ids past
    # it, and the head does not depend on the flush.
    new_j, _ = JP._compact_route_core(st_j, jnp.zeros((3, 1), jnp.float32),
                                      k_new=k_new, lanes_per_pixel=1)
    new_t, drop_pix, drop_rad = TP._route_partition(st_t, k_new)
    _assert_states_equal(new_t, new_j, f"n={n} {kind} k_new={k_new}")
    dead = np.flatnonzero(~alive)
    gone = dead[max(0, k_new - n_alive):]
    np.testing.assert_array_equal(drop_pix.numpy(), pix[gone])
    np.testing.assert_array_equal(drop_rad.numpy(),
                                  st_t.radiance_sum.numpy()[:, gone])
    assert new_t.pixel.dtype == torch.int32 and new_t.s_base.dtype == torch.int32
    # The kernels take contiguous rows.
    assert all(x.is_contiguous() for x in new_t)


@pytest.mark.parametrize("tail_sorted", [False, True])
def test_route_compaction_matches_sort_and_reference(tail_sorted):
    """On an ascending state (the host loop's invariant when tail_sorted is
    passed) the route compactor's alive lanes sit in the sort compactor's
    slots, bit for bit; its padding is inert (zero quota and sample, never
    respawned); per pixel, flushed plus retained radiance equals the sort
    engine's and the JAX route compactor's."""
    rng = np.random.default_rng(9)
    n, k_new, kpp, n_pix = 4096, 2048, 2, 4096
    alive = rng.uniform(size=n) < 0.3
    pix = np.sort(rng.integers(0, n_pix * kpp, n))
    arrs = _state_np(n, alive, pix, seed=4)
    st_j, st_t = _both(arrs)
    acc0 = rng.uniform(0, 1, (3, n_pix)).astype(np.float32)
    new_r, acc_r = TP._compact_route(st_t, torch.from_numpy(acc0.copy()),
                                     k_new=k_new, lanes_per_pixel=kpp)
    new_s, acc_s = TP._compact(st_t, torch.from_numpy(acc0.copy()),
                               k_new=k_new, lanes_per_pixel=kpp,
                               tail_sorted=tail_sorted)
    new_j, acc_j = JP._compact_route_core(st_j, jnp.asarray(acc0),
                                          k_new=k_new, lanes_per_pixel=kpp)
    na = int(alive.sum())
    for f in TP.PathState._fields:
        np.testing.assert_array_equal(getattr(new_r, f).numpy()[:, :na],
                                      getattr(new_s, f).numpy()[:, :na],
                                      err_msg=f)
    _assert_states_equal(new_r, new_j)
    assert not new_r.path_alive[0, na:].any()
    assert (new_r.s_quota[0, na:] == 0).all() and (new_r.sample[0, na:] == 0).all()

    def totals(new, acc):
        t = np.asarray(acc, np.float64).copy()
        np.add.at(t.T, np.asarray(new.pixel[0]) // kpp,
                  np.asarray(new.radiance_sum, np.float64).T)
        return t
    np.testing.assert_allclose(totals(new_r, acc_r), totals(new_s, acc_s),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(acc_r.numpy(), np.asarray(acc_j),
                               rtol=RTOL, atol=ATOL)


def _render_pair(monkeypatch, knob, floor=512, **kw):
    """The test scene at 64x32, 16 spp, one_shot off, on both packages'
    CPU paths with their compaction floors lowered to ``floor``, with and
    without ``knob``: (port default, port knob, JAX knob) linear images."""
    monkeypatch.setattr(JP, "_COMPACT_FLOOR", floor)
    monkeypatch.setattr(TP, "_COMPACT_FLOOR", floor)
    base = dict(width=64, height=32, samples=16, seed=11, one_shot="off", **kw)
    ours0 = TP.render_image_persistent(port_scene(), None, TC(**base)).numpy()
    ours = TP.render_image_persistent(port_scene(), None,
                                      TC(**base, **knob)).numpy()
    ref = np.asarray(JP.render_image_persistent(
        jax_test_scene(), None, JC(backend="jnp", **base, **knob)))
    return ours0, ours, ref


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


@pytest.mark.parametrize("knob", [dict(compactor="route"),
                                  dict(flush_mode="window")])
def test_knob_render_matches_default_and_reference(knob, monkeypatch):
    """A render with the route compactor or the window flush equals the
    default render to f32 summation order (the reference's rtol 2e-5,
    atol 2e-6: the live lanes and so the draws are the same), and the JAX
    render with the same knob within mean |diff| 2e-3 and pearson r >=
    0.9999 of its linear image (the packages' hit sweeps differ in the
    last bits)."""
    calls = []
    spied = TP._compact_route if "compactor" in knob else TP._window_flush
    name = spied.__name__
    monkeypatch.setattr(TP, name,
                        lambda *a, **k: calls.append(1) or spied(*a, **k))
    ours0, ours, ref = _render_pair(monkeypatch, knob)
    assert calls, f"{name} did not run"
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ours0, rtol=2e-5, atol=2e-6)
    d, r = _stats(ours, ref)
    assert d <= 2e-3 and r >= 0.9999, (d, r)


WINDOW_CASES = {
    "empty": lambda rng, p: np.zeros(0, np.int64),
    "one": lambda rng, p: np.array([p // 2]),
    "1023": lambda rng, p: np.sort(rng.integers(0, p, 1023)),
    "5000": lambda rng, p: np.sort(rng.integers(0, p, 5000)),
    "last pixel": lambda rng, p: np.array([p - 1] * 7),
    "dense to P-1": lambda rng, p: np.sort(np.concatenate(
        [rng.integers(p - 300, p, 2000), [p - 1] * 40])),
    "long run": lambda rng, p: np.repeat(np.arange(3), [10, 2100, 5]),
    # Blocks spanning more than the window: the run-sum path.
    "sparse": lambda rng, p: np.sort(np.concatenate(
        [rng.integers(0, 64, 800), rng.integers(p - 64, p, 800)])),
    "sparse blocks": lambda rng, p: np.sort(rng.choice(p, 2500, replace=False)),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_flush_matches_reference_and_index_add(case):
    """_window_flush on an ascending stream equals index_add_ and JAX's
    _window_flush to f32 summation order, in place, on streams of 0, 1,
    1,023 and 5,000 entries, ids at P - 1, runs across blocks and blocks
    that overflow their window."""
    rng = np.random.default_rng(len(case))
    p = 4096
    pix = WINDOW_CASES[case](rng, p).astype(np.int32)
    rad = rng.uniform(0, 1, (3, pix.size)).astype(np.float32)
    acc0 = rng.uniform(0, 1, (3, p)).astype(np.float32)
    acc = torch.from_numpy(acc0.copy())
    got = TP._window_flush(acc, torch.from_numpy(pix), torch.from_numpy(rad))
    assert got is acc
    want = torch.from_numpy(acc0.copy()).index_add_(
        1, torch.from_numpy(pix).long(), torch.from_numpy(rad))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    ref = np.asarray(JP._window_flush(jnp.asarray(acc0), jnp.asarray(pix),
                                      jnp.asarray(rad)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_window_flush_takes_the_run_sum_path_only_for_overflow(monkeypatch):
    """The run-sum flush sees the boundary stream (two entries a block)
    always, and the overflowing blocks' entries only when a block spans
    more than the window."""
    seen = []
    real = TP._flush
    monkeypatch.setattr(TP, "_flush", lambda acc, pix, rad, **k:
                        seen.append(pix.shape[0]) or real(acc, pix, rad, **k))
    acc = torch.zeros((3, 4096))
    dense = torch.sort(torch.randint(0, 1000, (3000,), dtype=torch.int32)).values
    TP._window_flush(acc, dense, torch.ones((3, 3000)))
    assert seen == [2 * 3]
    seen.clear()
    sparse = torch.arange(0, 4096, 2, dtype=torch.int32)   # 2,048 over 4,096
    TP._window_flush(acc, sparse, torch.ones((3, 2048)))
    assert seen == [4, 2048]


@pytest.mark.parametrize("ascending", [True, False])
def test_run_sum_flush(ascending):
    """_flush equals index_add_ to f32 summation order, adds each run as
    the doubling scan's fixed tree (the same on any permutation of an
    unsorted stream with the same per-pixel order), and hands index_add_
    one nonzero addend per pixel."""
    rng = np.random.default_rng(5)
    p, t = 1000, 6000
    pix = np.sort(rng.integers(0, p, t)) if ascending else rng.integers(0, p, t)
    pix[:300] = pix[0] if ascending else 7      # a long run
    pix = torch.from_numpy(pix.astype(np.int32))
    rad = torch.from_numpy(rng.uniform(0, 1, (3, t)).astype(np.float32))
    acc0 = torch.from_numpy(rng.uniform(0, 1, (3, p)).astype(np.float32))
    got = TP._flush(acc0.clone(), pix, rad, ascending=ascending)
    want = acc0.clone().index_add_(1, pix.long(), rad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    sp = torch.sort(pix, stable=True)
    sums = TP._run_sums(sp.values, rad[:, sp.indices])
    nz = (sums != 0).any(0)
    assert torch.equal(torch.unique(sp.values[nz]), torch.unique(pix))
    assert int(nz.sum()) == torch.unique(pix).numel()
    # The pixels' entries interleaved otherwise, each pixel's own in their
    # order: the same bits.
    if not ascending:
        rank = torch.from_numpy(rng.permutation(p))[pix.long()]
        mixed = torch.sort(rank, stable=True).indices
        again = TP._flush(acc0.clone(), pix[mixed], rad[:, mixed])
        assert torch.equal(again, got)


@pytest.mark.parametrize("tail_sorted", [True, False])
def test_receivers_match_reference(tail_sorted):
    """_compact with n_receivers (the sort engine) equals JAX's
    _compact_core with the same receivers bit for bit in every state
    field; the accumulator to f32 summation order; per pixel the quotas of
    unstarted samples are unchanged, and the receivers are dead and fresh."""
    rng = np.random.default_rng(7)
    n, kpp, quota = 4096, 4, 25
    hw = n // kpp
    alive = rng.uniform(size=n) < 0.4
    arrs = _state_np(n, alive, np.arange(n), seed=8)
    sample = rng.integers(0, quota, n).astype(np.int32)
    sample[~alive] = quota - 1
    arrs.update(sample=sample[None],
                s_base=(np.arange(n) % kpp * quota)[None].astype(np.int32),
                s_quota=np.full((1, n), quota, np.int32))
    if not tail_sorted:
        perm = rng.permutation(n)
        arrs = {k: v[:, perm] for k, v in arrs.items()}
    st_j, st_t = _both(arrs)
    acc0 = np.zeros((3, hw), np.float32)
    k_new, n_recv = 3072, 1024
    new_t, acc_t = TP._compact(st_t, torch.from_numpy(acc0.copy()),
                               k_new=k_new, lanes_per_pixel=kpp,
                               tail_sorted=tail_sorted, n_receivers=n_recv)
    new_j, acc_j = JP._compact_core(st_j, jnp.asarray(acc0), k_new=k_new,
                                    lanes_per_pixel=kpp,
                                    tail_sorted=tail_sorted,
                                    n_receivers=n_recv)
    _assert_states_equal(new_t, new_j, f"tail_sorted={tail_sorted}")
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j),
                               rtol=RTOL, atol=ATOL)

    def remaining(s):
        rem = np.maximum(s.s_quota.numpy()[0] - 1 - s.sample.numpy()[0], 0)
        out = np.zeros(hw, np.int64)
        np.add.at(out, s.pixel.numpy()[0] // kpp, rem)
        return out
    np.testing.assert_array_equal(remaining(new_t), remaining(st_t))
    r0 = k_new - n_recv
    assert not new_t.path_alive[0, r0:].any()
    assert (new_t.sample[0, r0:] == -1).all()
    assert int(new_t.s_quota[0, r0:].sum()) > 0


def test_redistribute_render(monkeypatch):
    """redistribute="on" at a toy size (floor 256, _RECV_MIN 64 in both
    packages): receiver events run, and the render matches the JAX render
    with the same knob (mean |diff| <= 0.01, pearson r >= 0.99) and the
    wavefront (mean |diff| < 0.03, the reference's bound), its image
    statistically."""
    events = []
    real = TP._receive
    monkeypatch.setattr(TP, "_receive",
                        lambda *a, **k: events.append(a[2]) or real(*a, **k))
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "_COMPACT_FLOOR", 256)
        monkeypatch.setattr(mod, "_RECV_MIN", 64)
    # 16,384 lanes: the alive counts clear the 4,096-lane minimum batch.
    kw = dict(width=64, height=32, samples=32, seed=3,
              rays_per_chunk=1 << 15, redistribute="on")
    ours = TP.render_image_persistent(port_scene(), None, TC(**kw)).numpy()
    assert events, "no receiver event"
    ref = np.asarray(JP.render_image_persistent(
        jax_test_scene(), None, JC(backend="jnp", **kw)))
    d, r = _stats(ours, ref)
    assert d <= 0.01 and r >= 0.99, (d, r)
    wave = np.asarray(jax_render_image(jax_test_scene(), None,
                                       JC(backend="jnp", **kw)))
    assert np.isfinite(ours).all()
    assert np.abs(ours - wave).mean() < 0.03
