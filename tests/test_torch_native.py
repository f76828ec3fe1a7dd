"""PyTorch port: the ctypes wrappers of ``native/librtnative.so`` (the BMP
encoder, io/native.py, and the reference-semantics oracle, oracle.py)
against the JAX package's wrappers of the same library.  The library is
built from the repository's ``native/`` with make; the tests skip only when
it cannot be built.  Every comparison is byte for byte."""

import numpy as np
import pytest

from win32_raytracer_tpu import oracle as joracle
from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.io import image as jimage
from win32_raytracer_tpu.io import native as jnative
from win32_raytracer_tpu.scene import builders as jb
from win32_raytracer_tpu_torch import oracle
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.io import image as timage
from win32_raytracer_tpu_torch.io import native
from win32_raytracer_tpu_torch.scene import builders as tb


@pytest.fixture(scope="module")
def built():
    if not oracle.build_native():
        pytest.skip("native/librtnative.so cannot be built (make -C native)")


@pytest.mark.parametrize("shape", [(32, 48), (7, 13), (1, 1)])
def test_native_bmp_bytes(built, shape, tmp_path, monkeypatch):
    """rt_encode_bmp's bytes equal the port's Python encoder's and the
    reference's; write_image writes the same file with and without the
    library."""
    img = np.random.default_rng(shape[1]).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    ours = native.try_encode(".bmp", img)
    assert ours is not None and native.load() is not None
    assert ours == timage.encode_bmp(img)
    assert ours == jnative.try_encode(".bmp", img) == jimage.encode_bmp(img)
    assert native.try_encode(".png", img) is None
    timage.write_image(str(tmp_path / "a.bmp"), img)
    monkeypatch.setattr(native, "load", lambda: None)
    timage.write_image(str(tmp_path / "b.bmp"), img)
    assert (tmp_path / "a.bmp").read_bytes() == (tmp_path / "b.bmp").read_bytes() == ours


ORACLE_CASES = {
    "test": dict(width=48, height=32, samples=4, seed=13),
    "final": dict(width=40, height=24, samples=2, seed=3),
}


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracle_render_matches_reference(built, name, linear):
    """The port's oracle_render (the port's scene tensors packed for the C
    ABI) gives the reference wrapper's bytes: u8 and linear images, with a
    thin-lens camera and the reference's quirk settings."""
    kw = ORACLE_CASES[name]
    look = ((15.0, 2.0, 4.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    focus = float(np.linalg.norm(np.subtract(look[0], look[1])))
    ours = oracle.oracle_render(tb.get_scene(name), *look, 20.0, 0.1, focus,
                                TC(**kw), linear=linear)
    ref = joracle.oracle_render(jb.get_scene(name), *look, 20.0, 0.1, focus,
                                JC(**kw), linear=linear)
    assert ours.dtype == ref.dtype and ours.shape == (kw["height"], kw["width"], 3)
    assert ours.tobytes() == ref.tobytes()


def test_oracle_deterministic_and_truncated(built):
    """deterministic=True and lane_truncate pass through as the reference's
    do."""
    kw = dict(width=32, height=24, samples=2, seed=7)
    look = ((0.0, 1.0, 4.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0))
    for extra in (dict(deterministic=True), dict(lane_truncate=3)):
        ours = oracle.oracle_render(tb.get_scene("test"), *look, 45.0, 0.0,
                                    4.0, TC(**kw), **extra)
        ref = joracle.oracle_render(jb.get_scene("test"), *look, 45.0, 0.0,
                                    4.0, JC(**kw), **extra)
        assert ours.tobytes() == ref.tobytes(), extra
