"""PyTorch port: the bounce routes of the persistent scheduler
(``fuse_bounce``, ``scatter_backend``, ``hit_kernel``, ``multi_backend``)
against the JAX package.

On the CPU the port's "auto" backend takes the routes of the reference's
Pallas backend, with the kernels' plain versions at their ends, so every
route runs here; spies on the four route functions show which ran.  The
split routes' images are held to ``scatter_backend="jnp"``'s bit for bit.
The reference renders on its jnp backend on the CPU, where these knobs change
nothing, so its one image per scene is what every route must match
statistically.  Where the reference raises (on its Pallas backend), the
port raises the same exception type.  On the card, chip_smoke.py phase 11
renders the headline once per route and reads the kernels' launch
counts."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.api import render as jax_render
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.scene.builders import get_scene as jax_get_scene
from win32_raytracer_tpu.scene.camera import default_camera as jax_camera
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.api import render
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.kernels import bounce as B
from win32_raytracer_tpu_torch.kernels import hit_sky as E
from win32_raytracer_tpu_torch.kernels import scatter as F
from win32_raytracer_tpu_torch.scene.builders import get_scene
from win32_raytracer_tpu_torch.scene.camera import default_camera

torch.set_num_threads(1)

# 12,288 lanes (8 per pixel) over a lowered compaction floor: bounces above
# the floor, compaction, then the tail below it.
KW = dict(width=48, height=32, samples=8, seed=5, lanes_per_pixel=8)
FLOOR = 1 << 12
# Against the reference's image (as test_torch_render.py's compaction mode).
MAX_DIFF, MIN_R = 0.06, 0.9999

# (knob, value) -> the route functions that run on the final scene.  Where
# kernel B runs, the tail below the floor takes kernels B-multi and B too,
# unless multi_backend="xla" keeps the torch chain there.  Where it does
# not, the split bounce's scatter + respawn is kernel F, unless an explicit
# scatter_backend="jnp" keeps the torch scatter.
ROUTES = {
    ("fuse_bounce", "auto"): {"bounce", "bounce_multi"},
    ("fuse_bounce", "on"): {"bounce", "bounce_multi"},
    ("fuse_bounce", "off"): {"hit_sky", "scatter"},
    ("scatter_backend", "auto"): {"bounce", "bounce_multi"},
    ("scatter_backend", "pallas"): {"hit_sky", "scatter"},
    ("scatter_backend", "jnp"): {"hit_sky"},
    ("hit_kernel", "auto"): {"bounce", "bounce_multi"},
    ("hit_kernel", "v4"): {"scatter"},
    ("hit_kernel", "v6"): {"scatter"},
    ("hit_kernel", "v7"): {"bounce", "bounce_multi"},
    ("multi_backend", ""): {"bounce", "bounce_multi"},
    ("multi_backend", "xla"): {"bounce"},
    ("multi_backend", "fused"): {"bounce", "bounce_multi"},
}
_SPIED = {"bounce": (B, "bounce"), "bounce_multi": (B, "bounce_multi"),
          "hit_sky": (E, "hit_sky"), "scatter": (F, "scatter_respawn")}
_PORT, _REF = {}, {}


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


def _port_render(scene, knobs):
    """(image, route functions that ran) of a port render at KW, cached."""
    knobs = {k: v for k, v in knobs.items() if getattr(TC(), k) != v}
    key = (scene, tuple(sorted(knobs.items())))
    if key not in _PORT:
        ran, saved = set(), {}

        def spy(name, fn):
            def wrapped(*a, **k):
                ran.add(name)
                return fn(*a, **k)
            return wrapped
        for name, (mod, attr) in _SPIED.items():
            saved[name] = getattr(mod, attr)
            setattr(mod, attr, spy(name, saved[name]))
        floor, TP._COMPACT_FLOOR = TP._COMPACT_FLOOR, FLOOR
        try:
            img = render(scene, cfg=TC(**KW, **knobs), device="cpu").image
        finally:
            TP._COMPACT_FLOOR = floor
            for name, (mod, attr) in _SPIED.items():
                setattr(mod, attr, saved[name])
        _PORT[key] = img, ran
    return _PORT[key]


def _ref_render(scene):
    if scene not in _REF:
        floor, JP._COMPACT_FLOOR = JP._COMPACT_FLOOR, FLOOR
        try:
            _REF[scene] = jax_render(scene, cfg=JC(**KW)).image
        finally:
            JP._COMPACT_FLOOR = floor
    return _REF[scene]


@pytest.mark.parametrize("knob,value", sorted(ROUTES),
                         ids=[f"{k}={v or repr(v)}" for k, v in sorted(ROUTES)])
def test_route_renders_and_matches_reference(knob, value):
    img, ran = _port_render("final", {knob: value})
    assert ran == ROUTES[(knob, value)], ran
    assert img.shape == (32, 48, 3)
    d, r = _stats(img, _ref_render("final"))
    assert d <= MAX_DIFF and r >= MIN_R, (d, r)


def test_pallas_scatter_on_a_mesh():
    """scatter_backend="pallas" reaches triangle scenes above the floor
    (kernel F after the composite hit), as in the reference; there is no
    fused bounce and no hit + sky kernel for triangles."""
    img, ran = _port_render("mesh", {"scatter_backend": "pallas"})
    assert ran == {"scatter"}, ran
    d, r = _stats(img, _ref_render("mesh"))
    assert d <= MAX_DIFF and r >= MIN_R, (d, r)


def test_binned_and_triangle_scenes_take_no_fused_route():
    """The fused bounce, its k-bounce and kernel E need a plain sphere
    table; the split bounce then takes kernel F at every size, which is no
    one-shot conflict; a binned render takes single steps and no one-shot
    chunk."""
    routes = TP.resolve_routes(TC(multi_backend="fused"), object(), "cpu",
                               h_virt=32, kpp=1, bin_box=(0.0,) * 6)
    assert routes == TP._Routes(None, None, None, F.scatter_respawn, True,
                                "off")
    assert routes.multi is None
    unbinned = TP.resolve_routes(TC(), object(), "cpu", h_virt=32, kpp=1,
                                 bin_box=None)
    assert unbinned.split_tail and unbinned.one_shot == "chunk"
    # An explicit backend keeps its route: "pallas" kernel F above the
    # floor only (a one-shot conflict), "jnp" and the plain backend the
    # torch scatter; pixel ids of 2^24 and up keep the torch scatter.
    for cfg, scatter in ((TC(scatter_backend="pallas"), F.scatter_respawn),
                         (TC(scatter_backend="jnp"), None),
                         (TC(backend="jnp"), None),
                         (TC(width=4096, height=4096), None)):
        got = TP.resolve_routes(cfg, object(), "cpu", h_virt=cfg.height,
                                kpp=1, bin_box=None)
        assert got.scatter is scatter and not got.split_tail
        assert got.one_shot == ("off" if scatter else "chunk")


def _linear(scene, cam, cfg, spied=()):
    """(linear image, {spied name: [(width, bounces)]}) of a port render
    with the floor lowered; ``scene`` is a name or a scene; ``spied`` names
    attributes of ``TP``, ``B`` and ``F`` whose calls are recorded, except
    calls inside a recorded call (the plain kernels' own torch bounces)."""
    calls, saved, inside = {}, {}, []

    def spy(name, fn):
        def wrapped(*a, **k):
            if not inside:
                st = next(x for x in a if isinstance(x, TP.PathState))
                calls.setdefault(name, []).append(
                    (st.pixel.shape[1], k.get("k", 1)))
            inside.append(name)
            try:
                return fn(*a, **k)
            finally:
                inside.pop()
        return wrapped
    mods = {name: next(m for m in (TP, B, F) if hasattr(m, name))
            for name in spied}
    for name, mod in mods.items():
        saved[name] = getattr(mod, name)
        setattr(mod, name, spy(name, saved[name]))
    floor, TP._COMPACT_FLOOR = TP._COMPACT_FLOOR, FLOOR
    try:
        if isinstance(scene, str):
            scene = get_scene(scene)
        img = TP.render_image_persistent(scene, cam, TC(**cfg))
    finally:
        TP._COMPACT_FLOOR = floor
        for name, mod in mods.items():
            setattr(mod, name, saved[name])
    return img, calls


# The default tail against the torch chain's: KW on the final scene, a
# batch of two cameras, a chunk that starts at or below the floor (the
# whole-chunk one shot), the tail finisher and the staged tail.
TAIL_CASES = {
    "headline": (None, {}),
    "frames": ("orbit", {}),
    "one_shot_chunk": (None, dict(rays_per_chunk=4096)),
    "finisher": (None, dict(one_shot="on", check_period=2)),
    "staged": (None, dict(one_shot="staged")),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_default_tail_is_the_torch_chain_bit_for_bit(case):
    """Under the default ``multi_backend`` every bounce at or below the
    floor runs on kernels B-multi and B (their plain versions here) and
    none on the torch chain; the image equals ``multi_backend="xla"``'s,
    whose tail is that chain, bit for bit."""
    from win32_raytracer_tpu_torch.animation import orbit_path
    cams, kw = TAIL_CASES[case]
    cam = (orbit_path(n_frames=2, aspect_ratio=KW["width"] / KW["height"])
           if cams else None)
    cfg = dict(KW, **kw)
    spied = ("bounce", "bounce_multi", "p_bounce_step")
    got, ran = _linear("final", cam, cfg, spied)
    want, ran_x = _linear("final", cam, dict(cfg, multi_backend="xla"),
                          spied)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert "p_bounce_step" not in ran
    kernels = ran.get("bounce", []) + ran["bounce_multi"]
    assert "bounce_multi" not in ran_x
    # The same bounces below the floor on either route.
    below = sum(n for w, n in kernels if w <= FLOOR)
    assert below > 0
    assert below == sum(1 for w, _ in ran_x["p_bounce_step"] if w <= FLOOR)


def _gridded_mesh():
    """A mesh of 1,292 active triangles, over the grid threshold of 512:
    the triangle grid (kernel D's plain version here) and ray binning."""
    from win32_raytracer_tpu_torch.scene.builders import mesh_scene
    return mesh_scene(subdivisions=3)


# Renders with no kernel B: (scene, knobs, the tail span that must run).
# The mesh is cut to 32x24 (6,144 lanes: above the floor first); the
# one-shot forms on it: a chunk that starts at or below the floor, the
# tail finisher and the staged tail.
SPLIT_CASES = {
    "mesh": ("mesh", dict(width=32, height=24), "persistent.bounce_tail"),
    "binned_sphere_grid": ("final", dict(accel="grid", ray_binning="on"),
                           "persistent.bounce_tail"),
    "sphere_grid": ("final", dict(accel="grid"), "persistent.bounce_tail"),
    "mesh_grid": (_gridded_mesh, dict(width=32, height=24),
                  "persistent.bounce_tail"),
    "mesh_one_shot_chunk": ("mesh", dict(width=32, height=24,
                                         rays_per_chunk=2048),
                            "persistent.one_shot"),
    "mesh_finisher": ("mesh", dict(width=32, height=24, one_shot="on",
                                   check_period=2), "persistent.one_shot"),
    "mesh_staged": ("mesh", dict(width=32, height=24, one_shot="staged",
                                 check_period=2),
                    "persistent.staged"),
}
_SPLIT = {}


def _split_render(case, scatter_backend="auto"):
    """(linear image, spied calls, the recorder's log) of a SPLIT_CASES
    render, cached."""
    from win32_raytracer_tpu_torch.utils import profiling
    key = (case, scatter_backend)
    if key not in _SPLIT:
        scene, knobs, _ = SPLIT_CASES[case]
        cfg = dict(KW, **knobs, scatter_backend=scatter_backend)
        with profiling.recording():
            img, ran = _linear(scene() if callable(scene) else scene, None,
                               cfg, ("bounce", "bounce_multi",
                                     "scatter_respawn",
                                     "p_scatter_respawn_step"))
        _SPLIT[key] = img, ran, profiling.log()
    return _SPLIT[key]


@pytest.mark.parametrize("scene", list(SPLIT_CASES))
def test_scenes_without_kernel_b_keep_the_torch_tail(scene):
    """Meshes, brute and gridded, and the sphere grid, binned and not, have
    no kernel B and no kernel B-multi: every bounce is the split bounce,
    whose scatter + respawn is kernel F (its plain version here) above the
    floor and below it (the host loop's tail, the one-shot chunk, the tail
    finisher, the staged tail); no torch scatter step runs in the loop; the
    linear image equals scatter_backend="jnp"'s, whose split bounces run
    the torch scatter, bit for bit."""
    got, ran, log = _split_render(scene)
    want, ran_jnp, _ = _split_render(scene, "jnp")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert "bounce" not in ran and "bounce_multi" not in ran
    assert "p_scatter_respawn_step" not in ran
    widths = [w for w, _ in ran["scatter_respawn"]]
    assert any(w <= FLOOR for w in widths)
    if "one_shot" not in scene:
        assert any(w > FLOOR for w in widths)
    assert SPLIT_CASES[scene][2] in [s["name"] for s in log["spans"]]
    # The same bounces on the torch scatter under "jnp".
    assert "scatter_respawn" not in ran_jnp
    assert sorted(widths) == sorted(w for w, _ in
                                    ran_jnp["p_scatter_respawn_step"])


@pytest.mark.parametrize("case", ["sphere_grid", "mesh_grid"])
def test_split_bounce_counters_by_scatter(case):
    """A recorded render with no kernel B counts each split bounce by what
    ran its scatter + respawn: ``persistent.scatter_kernel`` (kernel F) for
    every bounce under the default, ``persistent.scatter_torch`` for every
    one under scatter_backend="jnp"; the steps counters are the same."""
    (c,) = _split_render(case)[2]["counters"].values()
    (cj,) = _split_render(case, "jnp")[2]["counters"].values()
    bounces = c["persistent.steps_kernel"] + c["persistent.steps_tail"]
    assert c["persistent.steps_tail"] > 0 and c["persistent.steps_kernel"] > 0
    assert c["persistent.scatter_kernel"] == bounces
    assert "persistent.scatter_torch" not in c
    assert cj["persistent.scatter_torch"] == bounces
    assert "persistent.scatter_kernel" not in cj
    assert "persistent.steps_tail_fused" not in c
    for name in ("persistent.steps_kernel", "persistent.steps_tail",
                 "persistent.lanes_kernel", "persistent.lanes_tail"):
        assert c[name] == cj[name], name


def test_kernel_b_renders_count_no_split_bounce():
    """Where kernel B runs, above the floor and, through B-multi and B,
    below it, no bounce is split: neither scatter counter is made."""
    from win32_raytracer_tpu_torch.utils import profiling
    with profiling.recording():
        _linear("final", None, KW)
    (c,) = profiling.log()["counters"].values()
    assert c["persistent.steps_tail_fused"] > 0
    assert "persistent.scatter_kernel" not in c
    assert "persistent.scatter_torch" not in c


# (scene, config, frames): each raises ValueError in both packages.
RAISES = {
    "unknown hit_kernel": ("final", dict(hit_kernel="v9"), 1),
    "fuse on with v4": ("final", dict(fuse_bounce="on", hit_kernel="v4"), 1),
    "fuse on a mesh": ("mesh", dict(fuse_bounce="on"), 1),
    "pallas scatter past 2^24 pixels": (
        "final", dict(scatter_backend="pallas", width=4096, height=2048), 2),
    "fuse on past 2^24 pixels": (
        "final", dict(fuse_bounce="on", width=4096, height=4096), 1),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_route_raises_where_the_reference_raises(case):
    scene, kw, frames = RAISES[case]
    kw = dict(dict(width=16, height=8, samples=8), **kw)
    w, h = kw["width"], kw["height"]
    jcams = [jax_camera(w, h)] * frames
    with pytest.raises(ValueError) as ref:
        JP.render_image_persistent(jax_get_scene(scene),
                                   jcams if frames > 1 else jcams[0],
                                   JC(backend="pallas", **kw))
    tcams = [default_camera(w, h)] * frames
    with pytest.raises(type(ref.value)):
        TP.render_image_persistent(get_scene(scene),
                                   tcams if frames > 1 else tcams[0], TC(**kw))


@pytest.mark.parametrize("knob", ["scatter_backend", "fuse_bounce",
                                  "multi_backend"])
def test_unknown_route_values_raise(knob):
    """Stricter than the reference, which reads an unknown value as its
    knob's fallback: the port names the values it takes."""
    with pytest.raises(ValueError, match=knob):
        TP.render_image_persistent(get_scene("test"), None,
                                   TC(width=8, height=8, samples=8,
                                      **{knob: "bogus"}))
