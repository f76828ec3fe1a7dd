"""PyTorch port: config parity with the JAX package, import hygiene, and
knobs the port does not run yet."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from win32_raytracer_tpu.config import RenderConfig as JaxConfig
from win32_raytracer_tpu.config import resolve_scheduler as jax_resolve
from win32_raytracer_tpu_torch.config import RenderConfig, resolve_scheduler

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "win32_raytracer_tpu_torch")


def test_fields_and_defaults_match_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == ref


@pytest.mark.parametrize("scheduler", ["auto", "persistent", "wavefront"])
@pytest.mark.parametrize("deterministic", [False, True])
def test_resolve_scheduler_agrees(scheduler, deterministic):
    for spp in (1, 4, 7, 8, 100):
        kw = dict(scheduler=scheduler, deterministic=deterministic,
                  samples=spp)
        assert (resolve_scheduler(RenderConfig(**kw))
                == jax_resolve(JaxConfig(**kw)))
        assert (resolve_scheduler(RenderConfig(**kw), samples=16)
                == jax_resolve(JaxConfig(**kw), samples=16))


def test_package_imports_without_jax():
    code = ("import sys, win32_raytracer_tpu_torch, "
            "win32_raytracer_tpu_torch.persistent, "
            "win32_raytracer_tpu_torch.kernels.bounce, "
            "win32_raytracer_tpu_torch.kernels.dispatch, "
            "win32_raytracer_tpu_torch.kernels.tri, "
            "win32_raytracer_tpu_torch.kernels.tri_grid, "
            "win32_raytracer_tpu_torch.scene.triangles, "
            "win32_raytracer_tpu_torch.scene.composite, "
            "win32_raytracer_tpu_torch.tri_accel, "
            "win32_raytracer_tpu_torch.io.image, "
            "win32_raytracer_tpu_torch.render, "
            "win32_raytracer_tpu_torch.cli, "
            "win32_raytracer_tpu_torch.ops.scatter, "
            "win32_raytracer_tpu_torch.kernels.hit_cols, "
            "win32_raytracer_tpu_torch.kernels.tri_cols, "
            "win32_raytracer_tpu_torch.utils.progress; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'win32_raytracer_tpu.'))"
            " or m == 'win32_raytracer_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def _jax_imports(path):
    """(path, module) for each import of jax or the JAX package in a
    source file, nested imports included."""
    found = []
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for m in mods:
            top = m.split(".")[0]
            if top in ("jax", "jaxlib", "win32_raytracer_tpu"):
                found.append((path, m))
    return found


def test_no_jax_import_in_package_sources():
    found = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                found += _jax_imports(os.path.join(root, name))
    assert not found


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_render.py"])
def test_no_jax_import_in_card_scripts(script):
    """The scripts that run the port on the card import neither jax nor
    the JAX package, not even inside a function."""
    assert not _jax_imports(os.path.join(REPO, script))


def test_every_package_module_imports_without_jax():
    """Every module of the package, imported in a fresh process, leaves no
    jax and no module of the JAX package loaded."""
    mods = []
    for root, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    assert len(mods) > 40
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'win32_raytracer_tpu.')) or m == 'win32_raytracer_tpu']\n"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


@pytest.mark.parametrize("knob", [
    dict(tri_sub_gate=2),
    dict(tri_rebin="on"), dict(adaptive_alloc="on"),
    dict(tri_dda_k=4), dict(kpp_max=16),
    dict(pallas_interpret=True),
])
def test_unported_knobs_raise(knob):
    from win32_raytracer_tpu_torch.persistent import check_supported
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(RenderConfig(**knob))


def test_only_unported_knobs_remain():
    """What still raises NotImplementedError: the triangle grid's other
    arms (Queue 1 item 9), adaptive allocation (item 8) and
    pallas_interpret (not to port)."""
    from win32_raytracer_tpu_torch.persistent import _SUPPORTED
    assert sorted(_SUPPORTED) == sorted([
        "tri_sub_gate", "tri_rebin", "tri_dda_k", "adaptive_alloc",
        "adaptive_pool", "kpp_max", "pallas_interpret"])


# Every value of the scheduler knobs the reference accepts (its config.py
# comments), the defaults included.
SCHEDULER_KNOBS = [
    dict(one_shot=v) for v in ("auto", "on", "off", "staged")] + [
    dict(compactor=v) for v in ("", "sort", "route")] + [
    dict(flush_mode=v) for v in ("", "scatter", "window")] + [
    dict(redistribute=v) for v in ("auto", "on", "off")]


_KNOB_BASE = {}


@pytest.mark.parametrize("knob", SCHEDULER_KNOBS,
                         ids=lambda k: "%s=%s" % next(iter(k.items())))
def test_scheduler_knobs_run(knob, monkeypatch):
    """Each value passes check_supported and renders 64x32 at 16 spp on
    the CPU with the compaction floor lowered to 1,024 lanes, so that the
    16,384-lane chunk compacts above the floor and splits below it; the
    image is finite and every sample of the sky-lit test scene landed
    (mean within 0.02 of the default render's)."""
    import win32_raytracer_tpu_torch.persistent as P
    from win32_raytracer_tpu_torch.scene.builders import test_scene
    P.check_supported(RenderConfig(**knob))
    monkeypatch.setattr(P, "_COMPACT_FLOOR", 1024)
    monkeypatch.setattr(P, "_RECV_MIN", 64)
    cfg = RenderConfig(width=64, height=32, samples=16, seed=4,
                       lanes_per_pixel=8)
    if not _KNOB_BASE:
        _KNOB_BASE["mean"] = float(
            P.render_image_persistent(test_scene(), None, cfg).mean())
    img = P.render_image_persistent(test_scene(), None, cfg.replace(**knob))
    assert img.shape == (32, 64, 3) and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - _KNOB_BASE["mean"]) < 0.02


@pytest.mark.parametrize("knob", [dict(one_shot="sometimes"),
                                  dict(compactor="radix"),
                                  dict(flush_mode="gather"),
                                  dict(redistribute="yes")])
def test_unknown_scheduler_knob_values_raise(knob):
    from win32_raytracer_tpu_torch.persistent import check_supported
    with pytest.raises(ValueError, match=next(iter(knob))):
        check_supported(RenderConfig(**knob))


def test_wavefront_and_multi_frame_raise():
    """Single renders and animations on the wavefront scheduler run (a
    frame at a time); multi-frame batches need the persistent scheduler
    and raise ValueError, as in the reference; a camera list handed to
    render raises TypeError."""
    from win32_raytracer_tpu_torch.animation import render_animation
    from win32_raytracer_tpu_torch.api import render
    from win32_raytracer_tpu_torch.scene.builders import test_scene
    from win32_raytracer_tpu_torch.scene.camera import default_camera
    res = render("test", cfg=RenderConfig(width=8, height=8, samples=2),
                 device="cpu")
    assert res.image.shape == (8, 8, 3)
    cams = [default_camera(8, 8)] * 2
    frames = render_animation(test_scene(), cams,
                              RenderConfig(width=8, height=8, samples=2),
                              device="cpu")
    assert len(frames) == 2 and frames[0].shape == (8, 8, 3)
    with pytest.raises(ValueError, match="persistent"):
        render_animation(test_scene(), cams,
                         RenderConfig(width=8, height=8, samples=2),
                         batch_frames=2, device="cpu")
    with pytest.raises(TypeError, match="render_animation"):
        render("test", cams, RenderConfig(width=8, height=8, samples=8),
               device="cpu")


def test_pallas_backend_needs_a_card():
    from win32_raytracer_tpu_torch.kernels.dispatch import resolve_backend
    assert resolve_backend(RenderConfig(), "cpu") == "kernels"
    assert resolve_backend(RenderConfig(backend="jnp"), "cpu") == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        resolve_backend(RenderConfig(backend="pallas"), "cpu")


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_cuda_device_resolves_to_kernel_wrappers(backend):
    """On a CUDA device only an explicit backend="jnp" reaches the plain
    ops; "auto" and "pallas" go through the kernel wrappers."""
    from win32_raytracer_tpu_torch.kernels import hit as K
    from win32_raytracer_tpu_torch.kernels.dispatch import (
        get_hit_fn_rows, resolve_backend)
    cfg = RenderConfig(backend=backend)
    assert resolve_backend(cfg, "cuda") == "kernels"
    assert get_hit_fn_rows(cfg, "cuda") is K.hit_spheres_rows
    jnp_cfg = RenderConfig(backend="jnp")
    assert get_hit_fn_rows(jnp_cfg, "cuda") is K.hit_spheres_rows_plain
