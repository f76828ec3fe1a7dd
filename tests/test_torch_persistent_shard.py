"""PyTorch port: the persistent scheduler over a mesh of ranks
(``parallel/persistent_shard.py``) against the JAX package's sharded
scheduler on its virtual CPU mesh (tests/conftest.py).

The port runs D = 2 and D = 4 gloo ranks on the CPU, one group per D for
the whole module (``torch_shard_cases.run_cases``), through the kernels'
plain versions; JAX runs the same renders on a mesh of D virtual devices.
The lane partition, quotas, pads and salts are exact; renders are held
by mean |diff| of u8 and Pearson r (tests/test_torch_render.py's
metrics), each bound about twice the value measured, both written
beside it; the reference's invariance tests have twins here."""

import numpy as np
import pytest
import torch

import jax

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.parallel import persistent_shard as JPS
from win32_raytracer_tpu.parallel.shard import make_mesh as jax_mesh
from win32_raytracer_tpu.render import tonemap as jax_tonemap
from win32_raytracer_tpu.scene.builders import get_scene as jax_scene
from win32_raytracer_tpu.scene.builders import mesh_scene as jax_mesh_scene
from win32_raytracer_tpu_torch.parallel import persistent_shard as TPS
from win32_raytracer_tpu_torch.parallel.dryrun import spawn
from win32_raytracer_tpu_torch.render import tonemap

import torch_shard_cases as C

torch.set_num_threads(1)

R = dict(width=48, height=32, samples=8, seed=5)
COMPACT = dict(lanes_per_pixel=8, patches={"_COMPACT_FLOOR": 0})
ROUTE = dict(width=64, height=64, samples=16, seed=12, one_shot="off",
             patches={"_COMPACT_FLOOR": 2048})
ORBIT = ("orbit", dict(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                       n_frames=3, aspect_ratio=2.0))
ORBIT2 = ("orbit", dict(look_to=(0, 0.5, 0), radius=12.0, height=2.0,
                        n_frames=2, aspect_ratio=1.5))

CASES = {
    2: [(f"{s}-{m}", "persistent", dict(scene=s, **R,
                                         **(COMPACT if m == "compaction"
                                            else {})))
        for s in ("final", "test") for m in ("one-shot", "compaction")]
    + [("final-compaction-again", "persistent",
        dict(scene="final", **R, **COMPACT)),
       ("final-compaction-traced", "traced",
        dict(scene="final", **R, **COMPACT)),
       ("final-compaction-calls", "calls",
        dict(scene="final", **R, **COMPACT)),
       ("final-compaction-xla", "calls",
        dict(scene="final", **R, **COMPACT, multi_backend="xla"))],
    4: [(f"{s}-{m}", "persistent", dict(scene=s, **R,
                                         **(COMPACT if m == "compaction"
                                            else {})))
        for s in ("final", "test") for m in ("one-shot", "compaction")]
    + [
        ("multiframe", "persistent", dict(scene="test", cam=ORBIT, width=32,
                                          height=16, samples=16, seed=6)),
        ("adaptive-base", "persistent", dict(scene="test", width=48,
                                             height=40, samples=16, seed=9)),
        ("adaptive", "persistent", dict(scene="test", width=48, height=40,
                                        samples=16, seed=9,
                                        adaptive_alloc="on")),
        ("adaptive-frames", "persistent", dict(
            scene="test", cam=ORBIT2, width=24, height=16, samples=16, seed=3,
            adaptive_alloc="on")),
        ("composite", "persistent", dict(scene="mesh", width=32, height=16,
                                         samples=8, seed=3)),
        ("binned", "persistent", dict(scene="mesh3", width=32, height=16,
                                      samples=8, seed=5, accel="grid")),
        ("rebin-off", "persistent", dict(scene="mesh3", width=32, height=16,
                                         samples=8, seed=5, accel="grid",
                                         ray_binning="off")),
        ("rebin-on", "persistent", dict(scene="mesh3", width=32, height=16,
                                        samples=8, seed=5, accel="grid",
                                        ray_binning="off", tri_rebin="on")),
        ("staged", "persistent", dict(scene="test", width=96, height=64,
                                      samples=16, seed=5, one_shot="staged")),
        ("host-loop", "persistent", dict(scene="test", width=96, height=64,
                                         samples=16, seed=5, one_shot="off")),
        ("multi-k4", "persistent", dict(scene="test", width=64, height=32,
                                        samples=16, seed=5, one_shot="off")),
        ("multi-k8", "persistent", dict(scene="test", width=64, height=32,
                                        samples=16, seed=5, one_shot="off",
                                        multi_k=8)),
        ("one-shot-on", "persistent", dict(scene="test", width=64, height=32,
                                           samples=16, seed=8, one_shot="on")),
        ("one-shot-off", "persistent", dict(scene="test", width=64,
                                            height=32, samples=16, seed=8,
                                            one_shot="off")),
        ("conflict", "raises", dict(case="persistent", scene="mesh3",
                                    width=32, height=16, samples=8, seed=2,
                                    accel="grid", one_shot="on")),
        ("pool", "raises", dict(case="persistent", scene="test", width=16,
                                height=8, samples=16, adaptive_alloc="on",
                                adaptive_pool="on")),
        ("sky", "persistent", dict(scene="test", cam="sky", width=32,
                                   height=22, samples=8, seed=1)),
        ("sky-wrap", "persistent", dict(scene="test", cam="sky", width=16,
                                        height=37, samples=8, seed=1)),
        ("sort", "persistent", dict(scene="test", **ROUTE)),
        ("route", "persistent", dict(scene="test", compactor="route",
                                     **ROUTE)),
    ],
}
# The twins under multi_backend="xla" (the torch chain at or below the
# floor) of cases whose default runs kernels B-multi and B there (D = 2's
# is a "calls" case above), and a mesh (no kernel B) with its calls spied.
XLA_TWINS = {2: ("final-compaction",),
             4: ("final-compaction", "multiframe", "staged", "one-shot-on")}
CASES[4] += [(f"{n}-xla", "persistent", dict(kw, multi_backend="xla"))
             for n, _, kw in list(CASES[4]) if n in XLA_TWINS[4]]
CASES[4].append(("composite-calls", "calls",
                 dict(scene="mesh", width=32, height=16, samples=8, seed=3)))


@pytest.fixture(scope="module")
def ranks():
    """Rank 0's results of each group: {d: {case name: result}}."""
    return {d: spawn(d, C.run_cases, cases) for d, cases in CASES.items()}


def _kw(case_kw):
    return {k: v for k, v in case_kw.items()
            if k not in ("scene", "cam", "patches")}


def _case(d, name):
    return next(kw for n, _, kw in CASES[d] if n == name)


def _jax_render(d, name, monkeypatch=None):
    """The JAX sharded render of case ``name`` on a mesh of d devices."""
    kw = _case(d, name)
    for k, v in kw.get("patches", {}).items():
        monkeypatch.setattr(JP, k, v)
        monkeypatch.setattr(JPS, k, v)
    scene = (jax_mesh_scene(subdivisions=3) if kw["scene"] == "mesh3"
             else jax_scene(kw["scene"]))
    cam = None
    if kw.get("cam") is not None:
        from win32_raytracer_tpu.animation import orbit_path
        cam = orbit_path(**kw["cam"][1])
    return np.asarray(JPS.render_image_persistent_sharded(
        scene, cam, JC(backend="jnp", **_kw(kw)), jax_mesh(d)))


def _u8(lin, backend="torch"):
    lin = np.asarray(lin, np.float32)
    if backend == "jax":
        return np.asarray(jax_tonemap(jax.numpy.asarray(lin)))
    return tonemap(torch.from_numpy(lin)).numpy()


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


# --- exact: the lane partition, quotas, pads and salts -------------------

@pytest.mark.parametrize("h,w,kpp,d", [
    (32, 4, 2, 2),     # an even split: 4 blocks over 2 ranks
    (37, 16, 2, 8),    # a short last block (the reference's test)
    (67, 16, 1, 8),    # the short block wraps onto shard 0 (the reference's)
    (37, 5, 2, 4),     # the same at D = 4
    (16, 3, 4, 4),     # fewer blocks than ranks: whole blocks wrap
])
def test_interleaved_pixel_lanes_exact(h, w, kpp, d):
    got = TPS._interleaved_pixel_lanes(h, w, kpp, d)
    want = JPS._interleaved_pixel_lanes(h, w, kpp, d)
    np.testing.assert_array_equal(got, want)
    assert set(got.reshape(-1).tolist()) == set(range(h * w * kpp))


class _Caught(Exception):
    pass


def _jax_layout(cfg, d, monkeypatch, stop_after):
    """The numpy arrays the JAX sharded scheduler hands jax.device_put, in
    order, up to the ``stop_after``-th."""
    seen = []
    real = jax.device_put

    def spy(x, *a, **k):
        if isinstance(x, np.ndarray):
            seen.append(np.array(x))
            if len(seen) == stop_after:
                raise _Caught()
        return real(x, *a, **k)
    monkeypatch.setattr(jax, "device_put", spy)
    try:
        JPS.render_image_persistent_sharded(jax_scene("test"), None, cfg,
                                            jax_mesh(d))
    except _Caught:
        pass
    monkeypatch.setattr(jax, "device_put", real)
    return seen


@pytest.mark.parametrize("h,w,spp,d", [(32, 48, 8, 2), (67, 16, 8, 8),
                                       (37, 20, 16, 4)])
def test_quotas_pads_and_salts_exact(h, w, spp, d, monkeypatch):
    """Lanes (padded onto the size grid), quotas (the wrap dedupe) and
    per-rank salts are the JAX scheduler's own arrays."""
    cfg = JC(width=w, height=h, samples=spp, seed=7, backend="jnp")
    pix, q0, salts = _jax_layout(cfg, d, monkeypatch, stop_after=3)
    kpp = JP._resolve_kpp(cfg, spp, 1, w * h)
    lanes, quotas = TPS.shard_layout(h, w, kpp, spp // kpp, d)
    np.testing.assert_array_equal(lanes.reshape(1, -1), pix)
    np.testing.assert_array_equal(quotas.reshape(1, -1), q0)
    assert TPS.device_salts(7, d) == salts.tolist()
    # Every pixel-lane id renders its quota exactly once.
    per_lane = np.zeros(h * w * kpp, np.int64)
    np.add.at(per_lane, lanes.reshape(-1), quotas.reshape(-1))
    assert (per_lane == spp // kpp).all()


def test_adaptive_layout_and_salts_exact(monkeypatch):
    """The adaptive arm's unpadded lanes, prepass quotas, phase-2 pixel ids
    and quotas, and phase-2 salts against the JAX scheduler's arrays."""
    h, w, spp, d = 20, 16, 16, 4
    cfg = JC(width=w, height=h, samples=spp, seed=3, backend="jnp",
             adaptive_alloc="on")
    seen = _jax_layout(cfg, d, monkeypatch, stop_after=0)
    pix, q0, salts, q_pre, pix_ids, q_rest, salts2 = seen
    kpp = JP._resolve_kpp(cfg, spp, 1, w * h)
    lanes, quotas = TPS.shard_layout(h, w, kpp, spp // kpp, d, pad=False)
    np.testing.assert_array_equal(lanes.reshape(1, -1), pix)
    np.testing.assert_array_equal(quotas.reshape(1, -1), q0)
    np.testing.assert_array_equal((quotas > 0).astype(np.int32)
                                  .reshape(1, -1), q_pre)
    np.testing.assert_array_equal((lanes[:, ::kpp] // kpp).reshape(1, -1),
                                  pix_ids)
    np.testing.assert_array_equal(
        ((quotas[:, ::kpp] > 0) * (spp - kpp)).reshape(1, -1), q_rest)
    assert TPS.device_salts(3, d) == salts.tolist()
    assert [TPS.phase2_salt(s) for s in TPS.device_salts(3, d)] == \
        salts2.tolist()


# --- renders against the JAX sharded scheduler ---------------------------

# (scene, mode, d) -> (max mean |diff| of u8, min pearson r), about twice
# the values measured at seed 5 (in the comments: mean |diff|, r).  Both
# packages draw from the same counters on the same lanes; the differences
# are last-place f32 rounding through the scatter (final's glass).
BOUNDS = {
    ("final", "one-shot", 2): (0.18, 0.9997),       # 0.0896, 0.99985
    ("final", "compaction", 2): (0.06, 0.9999),     # 0.0265, 0.99998
    ("test", "one-shot", 2): (0.02, 0.99997),       # 0.0098, 0.999989
    ("test", "compaction", 2): (0.001, 0.99999),    # 0.00022, 1.0
    ("final", "one-shot", 4): (0.21, 0.9996),       # 0.1050, 0.99983
    ("final", "compaction", 4): (0.015, 0.99999),   # 0.0072, 0.999999
    ("test", "one-shot", 4): (0.01, 0.99999),       # 0.0, 1.0
    ("test", "compaction", 4): (0.001, 0.99999),    # 0.00022, 1.0
}


@pytest.mark.parametrize("scene,mode,d", sorted(BOUNDS))
def test_sharded_render_matches_reference(ranks, scene, mode, d,
                                          monkeypatch):
    """48x32 at 8 spp.  "one-shot": every rank's batch starts below the
    floor and runs whole.  "compaction": the floor patched to 0 in both
    packages (the per-rank floor is then 1,024 lanes) and 8 lanes per
    pixel, so the lockstep host loop compacts."""
    name = f"{scene}-{mode}"
    got = ranks[d][name]
    want = _jax_render(d, name, monkeypatch)
    assert got.shape == want.shape == (32, 48, 3)
    dd, r = _stats(_u8(got), _u8(want, "jax"))
    max_d, min_r = BOUNDS[(scene, mode, d)]
    assert dd <= max_d and r >= min_r, (dd, r)


def test_sharded_render_repeats_bit_for_bit(ranks):
    np.testing.assert_array_equal(ranks[2]["final-compaction"],
                                  ranks[2]["final-compaction-again"])


def test_sharded_recorder_lockstep_table(ranks):
    """2 gloo ranks with the recorder on (``recording()``): the image is
    bit-equal to the recorder off and to the untraced case; every rank
    timed the same lockstep collectives, one per ``shard.lockstep`` span,
    and rank 0's log holds the [ranks, collectives] table, which the
    benchmark parts into transfer and wait."""
    from port_bench import spans
    got = ranks[2]["final-compaction-traced"]
    assert got["equal"]
    np.testing.assert_array_equal(got["image"], ranks[2]["final-compaction"])
    log = got["log"]
    names = [s["name"] for s in log["spans"]]
    assert [n for n, s in zip(names, log["spans"]) if s["parent"] is None] == [
        "shard.render"]
    for name in ("persistent.chunk", "persistent.respawn",
                 "persistent.bounce_kernel", "persistent.count_read",
                 "persistent.compact", "persistent.flush", "shard.reduce"):
        assert name in names, name
    (table,) = [t for t in log["tables"] if t["name"] == "shard.lockstep_ms"]
    rows = table["rows"]
    n = names.count("shard.lockstep")
    assert n > 0 and len(rows) == 2 and all(len(r) == n for r in rows)
    assert all(v >= 0 for r in rows for v in r)
    transfer, wait = spans.lockstep_ms(log)
    least = sum(min(c) for c in zip(*rows))
    assert transfer == pytest.approx(least) and wait >= 0
    assert wait == pytest.approx((sum(map(sum, rows)) - 2 * least) / 2)
    (c,) = log["counters"].values()
    assert c["persistent.steps_kernel"] > 0
    assert 0 < c["persistent.alive_at_reads"] <= c["persistent.width_at_reads"]


# (case) -> (max mean |diff| of u8, min pearson r) against JAX at D = 4,
# about twice the values measured (in the comments).
CASE_BOUNDS = {
    "multiframe": (0.001, 0.99999),    # 0.00022, 1.0
    "adaptive": (0.01, 0.99999),       # 0.0, 1.0
    "composite": (0.01, 0.99999),      # 0.0, 1.0
    "binned": (0.002, 0.99999),        # 0.00065, 1.0
}


@pytest.mark.parametrize("name", sorted(CASE_BOUNDS))
def test_sharded_case_matches_reference(ranks, name, monkeypatch):
    """Multi-frame batches (3 orbit frames as one tall image), adaptive
    allocation per rank, the composite ``mesh`` scene and the binned
    triangle grid (each rank bin-sorts its own lanes) at D = 4."""
    got = ranks[4][name]
    want = _jax_render(4, name, monkeypatch)
    assert got.shape == want.shape
    a = _u8(got.reshape(-1, got.shape[-2], 3))
    b = _u8(want.reshape(-1, want.shape[-2], 3), "jax")
    dd, r = _stats(a, b)
    max_d, min_r = CASE_BOUNDS[name]
    assert dd <= max_d and r >= min_r, (dd, r)
    if name == "multiframe":
        assert np.abs(got[0] - got[2]).mean() > 0.005   # the camera moves


def test_sharded_adaptive_multiframe(ranks):
    """adaptive_alloc composes with multi-frame batches on the mesh (the
    reference's test_sharded_multiframe_adaptive, port against port)."""
    img = ranks[4]["adaptive-frames"]
    assert img.shape == (2, 16, 24, 3) and np.isfinite(img).all()
    base = ranks[4]["adaptive-base"]
    adap = ranks[4]["adaptive"]
    d = np.abs(np.sqrt(np.clip(adap, 0, 1)) - np.sqrt(np.clip(base, 0, 1)))
    assert d.mean() < 0.04, d.mean()


def test_sharded_tri_rebin_matches_off_exactly(ranks):
    np.testing.assert_array_equal(ranks[4]["rebin-on"], ranks[4]["rebin-off"])


def test_sharded_staged_matches_host_loop(ranks):
    stg, host = _u8(ranks[4]["staged"]), _u8(ranks[4]["host-loop"])
    diff = np.abs(stg.astype(float) - host.astype(float))
    assert diff.mean() < 4.0, diff.mean()


def test_sharded_multi_k_is_bitwise_invariant(ranks):
    np.testing.assert_array_equal(ranks[4]["multi-k4"], ranks[4]["multi-k8"])


def test_sharded_one_shot_matches_host_loop(ranks):
    on, off = ranks[4]["one-shot-on"], ranks[4]["one-shot-off"]
    assert on.shape == off.shape == (32, 64, 3)
    d = np.abs(np.sqrt(np.clip(on, 0, 1)) - np.sqrt(np.clip(off, 0, 1)))
    assert d.mean() < 0.03, d.mean()


def test_sharded_refusals(ranks):
    """Binned mesh renders need the host loop: one_shot='on' raises; the
    pooled adaptive estimate is single-card only."""
    kind, msg = ranks[4]["conflict"]
    assert kind == "ValueError" and "one_shot" in msg
    kind, msg = ranks[4]["pool"]
    assert kind == "ValueError" and "single-chip" in msg


@pytest.mark.parametrize("name", ["sky", "sky-wrap"])
def test_sharded_sample_accounting_sky(ranks, name):
    """Every pixel averages exactly its spp sky draws: no double or missing
    samples from the partition or the wrap (at h = 37 and D = 4 the short
    last block wraps onto the rank that owns block 0)."""
    lin = ranks[4][name]
    assert lin.min() >= 0.5 - 1e-5 and lin.max() <= 1.0 + 1e-5, (
        lin.min(), lin.max())


def test_sharded_route_compactor_matches_sort(ranks):
    base, routed = ranks[4]["sort"], ranks[4]["route"]
    assert np.isfinite(routed).all()
    np.testing.assert_allclose(routed, base, rtol=2e-5, atol=2e-6)


def _image(got):
    return got["image"] if isinstance(got, dict) else got


@pytest.mark.parametrize("d,name", [(d, n) for d, names in XLA_TWINS.items()
                                    for n in names])
def test_sharded_fused_tail_bit_equal_to_xla(ranks, d, name):
    """At or below the per-rank floor the default route runs kernels
    B-multi and B (their plain versions here) where the torch chain ran:
    in the host loop (the floor patched to 1,024 lanes a rank), the
    one-shot batches (a multi-frame orbit; one_shot="on") and the staged
    tail, the image is bit-equal to multi_backend="xla"'s."""
    np.testing.assert_array_equal(_image(ranks[d][name]),
                                  _image(ranks[d][f"{name}-xla"]))


TAIL_SPANS = {"persistent.bounce_tail", "persistent.one_shot",
              "persistent.staged"}


@pytest.mark.parametrize("name", ["final-compaction-calls",
                                  "final-compaction-xla"])
def test_sharded_tail_counts_by_route(ranks, name):
    """Rank 0's counters and kernel calls at D = 2 with the floor patched:
    under the default route every bounce at or below the per-rank floor
    is a kernel B-multi or B call inside a tail span, counted by
    ``persistent.steps_tail_fused`` and never by ``steps_tail``; under
    "xla" the reverse, and every kernel call is kernel B above the floor
    (or at it, after the torch k-bounce) inside
    ``persistent.bounce_kernel``."""
    got = ranks[2][name]
    c, floor = got["counters"], got["floor"]
    np.testing.assert_array_equal(got["image"], ranks[2]["final-compaction"])
    below = [(n, inner) for w, n, inner in got["calls"] if w <= floor]
    above = [inner for w, _, inner in got["calls"] if w > floor]
    assert above and all(inner == "persistent.bounce_kernel"
                         for inner in above)
    if name.endswith("xla"):
        assert c["persistent.steps_tail"] > 0
        assert "persistent.steps_tail_fused" not in c
        assert all(inner == "persistent.bounce_kernel" for _, inner in below)
        return
    assert below and all(inner in TAIL_SPANS for _, inner in below)
    assert c["persistent.steps_tail_fused"] == sum(n for n, _ in below)
    assert "persistent.steps_tail" not in c
    assert "persistent.lanes_tail" not in c


def test_sharded_mesh_keeps_torch_tail(ranks):
    """A mesh has no kernel B: below the floor the sharded driver runs
    the split bounce under the default route, its scatter + respawn on
    kernel F (its plain version here), as above the floor: counted by
    ``persistent.steps_tail`` and ``persistent.scatter_kernel``, with no
    kernel B-multi and no torch scatter."""
    got = ranks[4]["composite-calls"]
    c = got["counters"]
    assert not got["calls"]
    assert c["persistent.steps_tail"] > 0
    assert "persistent.steps_tail_fused" not in c
    assert c["persistent.scatter_kernel"] == (
        c["persistent.steps_tail"] + c.get("persistent.steps_kernel", 0))
    assert "persistent.scatter_torch" not in c
    np.testing.assert_array_equal(got["image"], ranks[4]["composite"])
