"""PyTorch port: whole renders against the JAX package and the native
oracle, tonemap and image encoders.

Both packages draw from the same counters (core/rng.py) and schedule the
same lanes, so on the CPU the port's images match the reference's nearly
pixel for pixel; the bounds are about 2x the values measured when the
test was written."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu import persistent as JP
from win32_raytracer_tpu.api import render as jax_render
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.io.image import encode_bmp as jax_bmp
from win32_raytracer_tpu.io.image import encode_png as jax_png
from win32_raytracer_tpu.io.image import encode_ppm as jax_ppm
from win32_raytracer_tpu.render import tonemap as jax_tonemap
from win32_raytracer_tpu_torch import persistent as TP
from win32_raytracer_tpu_torch.api import render, render_async
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.io import image as timage
from win32_raytracer_tpu_torch.render import tonemap

torch.set_num_threads(1)


def _stats(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    x, y = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
    r = float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))
    return float(np.abs(a - b).mean()), r


# (scene, mode) -> (max mean |diff|, min pearson r).  Measured at seed 5:
# final one-shot 0.0525 / 0.99995, final compaction 0.0267 / 0.99998,
# test scene 0.0 / 1.0 in both modes (identical images).
BOUNDS = {
    ("final", "one-shot"): (0.11, 0.9999),
    ("final", "compaction"): (0.06, 0.9999),
    ("test", "one-shot"): (0.01, 0.99999),
    ("test", "compaction"): (0.01, 0.99999),
}


@pytest.mark.parametrize("scene,mode", sorted(BOUNDS))
def test_render_matches_reference(scene, mode, monkeypatch):
    """48x32 at 8 spp.  "one-shot": chunks below the compaction floor run
    whole.  "compaction": the floor patched to 0 in both packages and 8
    lanes per pixel, so the checked host loop compacts and the port's
    fused-bounce wrapper runs (its plain version, on the CPU)."""
    kw = dict(width=48, height=32, samples=8, seed=5)
    compactions = []
    if mode == "compaction":
        kw["lanes_per_pixel"] = 8
        monkeypatch.setattr(JP, "_COMPACT_FLOOR", 0)
        monkeypatch.setattr(TP, "_COMPACT_FLOOR", 0)
        real = TP._compact

        def spy(*a, **k):
            compactions.append(k["k_new"])
            return real(*a, **k)
        monkeypatch.setattr(TP, "_compact", spy)
    ref = jax_render(scene, cfg=JC(**kw)).image
    res = render(scene, cfg=TC(**kw), device="cpu")
    assert res.image.shape == (32, 48, 3) and res.image.dtype == np.uint8
    assert res.device == "cpu"
    if mode == "compaction":
        assert compactions, "the compaction path did not run"
    d, r = _stats(res.image, ref)
    max_d, min_r = BOUNDS[(scene, mode)]
    assert d <= max_d and r >= min_r, (d, r)


def test_render_matches_native_oracle(monkeypatch):
    """tests/test_golden.py's production-path check, on the port."""
    from win32_raytracer_tpu_torch import oracle
    if not oracle.available():
        pytest.skip("native oracle not built")
    from win32_raytracer_tpu_torch.render import render as render_scene
    from win32_raytracer_tpu_torch.scene.builders import test_scene
    from win32_raytracer_tpu_torch.scene.camera import default_camera

    monkeypatch.setattr(TP, "_COMPACT_FLOOR", 0)
    kw = dict(width=48, height=32, samples=4, seed=13)
    ours = render_scene(test_scene(), default_camera(48, 32),
                        TC(scheduler="persistent", **kw))
    focus = float(np.linalg.norm(np.array([15.0, 2, 4]) - np.array([0.0, 1, 0])))
    ref = oracle.oracle_render(test_scene(), (15, 2, 4), (0, 1, 0), (0, 1, 0),
                               20.0, 0.1, focus, TC(**kw))
    d, r = _stats(ours, ref)
    assert d < 5.0, d
    assert r > 0.97, r


def test_tonemap_exact():
    rng = np.random.default_rng(0)
    lin = np.concatenate([rng.uniform(-0.5, 1.5, 5000),
                          [0.0, 1.0, 1e-9, 0.25, 0.999, 2.0]]).astype(np.float32)
    lin = lin.reshape(-1, 1, 2)[:2500].repeat(3, axis=2)[:, :, :3]
    np.testing.assert_array_equal(tonemap(torch.from_numpy(lin)).numpy(),
                                  np.asarray(jax_tonemap(jnp.asarray(lin))))


@pytest.mark.parametrize("shape", [(32, 48), (7, 13), (1, 1)])
def test_encoders_byte_identical(shape, tmp_path):
    img = np.random.default_rng(1).integers(0, 256, shape + (3,), np.uint8)
    assert timage.encode_bmp(img) == jax_bmp(img)
    assert timage.encode_png(img) == jax_png(img)
    assert timage.encode_ppm(img) == jax_ppm(img)
    path = tmp_path / "out.bmp"
    timage.write_image(str(path), img)
    assert path.read_bytes() == jax_bmp(img)


def test_render_async_and_result():
    got = []
    handle = render_async("test", cfg=TC(width=16, height=8, samples=8),
                          device="cpu", callback=got.append)
    res = handle.join(timeout=300)
    assert handle.done() and got and got[0] is res
    assert res.image.shape == (8, 16, 3)
    assert res.mrays_per_sec > 0 and len(res.image_parts) == 1
    with pytest.raises(NotImplementedError, match="item 11"):
        render("test", cfg=TC(width=8, height=8, samples=8), device="cpu",
               mesh=object())
