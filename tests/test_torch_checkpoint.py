"""PyTorch port: utils/checkpoint.py — pass- and chunk-level resume, the
refusals, and checkpoint files crossing between the two packages.

A resumed render must equal an uninterrupted one byte for byte (the
chunks' draws depend only on (seed, y0) and the flushes add in an order
fixed by their streams); the port's and the JAX package's files have the
same keys and format, and each package loads and resumes the other's."""

import numpy as np
import pytest
import torch

from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.scene.builders import test_scene as jax_test_scene
from win32_raytracer_tpu.utils import checkpoint as JK
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.scene.builders import test_scene as port_scene
from win32_raytracer_tpu_torch.utils import checkpoint as TK

torch.set_num_threads(1)


def _run(cfg, path, **kw):
    return TK.render_with_checkpoints(port_scene(), None, cfg, str(path),
                                      device="cpu", **kw)


def test_checkpoint_resume_identical_image(tmp_path):
    """Wavefront passes (2 spp each): a render stopped after 2 of 4
    passes and resumed equals the uninterrupted render."""
    cfg = TC(width=24, height=12, samples=8, seed=6, scheduler="wavefront")
    full = _run(cfg, tmp_path / "full.npz", passes=4)
    assert TK.load_checkpoint(str(tmp_path / "full.npz"))[1] == 4
    part = tmp_path / "part.npz"
    assert _run(cfg, part, passes=4, max_passes_per_run=2) is None
    assert TK.load_checkpoint(str(part))[1] == 2
    np.testing.assert_array_equal(_run(cfg, part, passes=4), full)


def test_checkpoint_resume_persistent_pass_level(tmp_path):
    """The persistent scheduler at pass granularity (roulette and
    stratification on): stopped after 1 of 2 passes and resumed, the same
    bytes."""
    cfg = TC(width=24, height=12, samples=32, seed=6, scheduler="persistent",
             russian_roulette=True, stratify=True)
    full = _run(cfg, tmp_path / "p.npz", passes=2)
    assert full is not None
    part = tmp_path / "p_part.npz"
    assert _run(cfg, part, passes=2, max_passes_per_run=1) is None
    np.testing.assert_array_equal(_run(cfg, part, passes=2), full)


def test_checkpoint_resume_persistent_chunk_level(tmp_path):
    """Mid-pass resume: 4-row chunks (kpp 4), stopped after 2 chunks of 4,
    resumed from the chunk accumulator, the same bytes."""
    cfg = TC(width=32, height=16, samples=16, seed=9, scheduler="persistent",
             rays_per_chunk=32 * 4 * 4)
    full = _run(cfg, tmp_path / "c.npz", passes=1)
    part = tmp_path / "c_part.npz"
    assert _run(cfg, part, passes=1, max_chunks_per_run=2) is None
    acc, done, meta = TK.load_checkpoint(str(part))
    assert done == 0 and meta["chunk_y0"] == 8
    assert meta["chunk_accum"].shape == (3, 32 * 16)
    np.testing.assert_array_equal(
        _run(cfg, part, passes=1, chunk_checkpoints=True), full)


def test_chunk_hooks_resume_bit_exact():
    """render_image_persistent's hooks: chunk_callback sees each chunk's
    accumulator and next row; resuming from any of them gives the
    uninterrupted linear image bit for bit."""
    from win32_raytracer_tpu_torch.persistent import render_image_persistent
    cfg = TC(width=32, height=16, samples=16, seed=9, rays_per_chunk=32 * 4 * 4)
    seen = []
    full = render_image_persistent(
        port_scene(), None, cfg,
        chunk_callback=lambda acc, y: seen.append((acc.clone(), y)))
    assert [y for _, y in seen] == [4, 8, 12, 16]
    for acc, y in seen[:-1]:
        again = render_image_persistent(port_scene(), None, cfg,
                                        resume_accum=acc.numpy(),
                                        resume_y0=y)
        assert torch.equal(again, full)
    with pytest.raises(ValueError, match="resume_accum"):
        render_image_persistent(port_scene(), None, cfg,
                                resume_accum=np.zeros((3, 5), np.float32))


def test_checkpoint_config_mismatch(tmp_path):
    cfg = TC(width=16, height=8, samples=4, seed=1, scheduler="wavefront")
    ck = tmp_path / "c.npz"
    _run(cfg, ck, passes=2)
    with pytest.raises(ValueError, match="does not match"):
        _run(cfg.replace(seed=2), ck, passes=2)


def test_checkpoint_rays_per_chunk_refusal(tmp_path):
    """A checkpoint written with other chunk boundaries or lane encoding
    would not resume bit-exact: refused."""
    cfg = TC(width=16, height=8, samples=16, seed=1, scheduler="persistent")
    ck = tmp_path / "r.npz"
    assert _run(cfg, ck, passes=2, max_passes_per_run=1) is None
    with pytest.raises(ValueError, match="rays_per_chunk"):
        _run(cfg.replace(rays_per_chunk=1 << 12), ck, passes=2)
    with pytest.raises(ValueError, match="lanes_per_pixel"):
        _run(cfg.replace(lanes_per_pixel=2), ck, passes=2)


def test_checkpoint_refusals(tmp_path):
    """On a mesh (one rank in this process) chunk checkpoints are refused
    and a pass must resolve the persistent scheduler; chunk checkpoints
    need the persistent scheduler; passes must divide the samples; without
    device= the card is required."""
    from torch_shard_cases import one_rank
    cfg = TC(width=16, height=8, samples=8, seed=1)
    with one_rank(tmp_path) as mesh:
        with pytest.raises(ValueError, match="chunk_checkpoints"):
            _run(cfg.replace(samples=16), "unused.npz", passes=1, mesh=mesh,
                 chunk_checkpoints=True)
        with pytest.raises(ValueError, match="sharded persistent"):
            _run(cfg, "unused.npz", passes=2, mesh=mesh)
    with pytest.raises(ValueError, match="persistent"):
        _run(cfg.replace(scheduler="wavefront"), "unused.npz", passes=2,
             chunk_checkpoints=True)
    with pytest.raises(ValueError, match="divide"):
        _run(cfg, "unused.npz", passes=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TK.render_with_checkpoints(port_scene(), None, cfg, "unused.npz",
                                       passes=2)


def _loads_alike(path):
    """Both packages' loaders read the same arrays and fields from one
    file."""
    ja, tb = JK.load_checkpoint(str(path)), TK.load_checkpoint(str(path))
    np.testing.assert_array_equal(ja[0], tb[0])
    assert ja[1] == tb[1]
    ma, mb = dict(ja[2]), dict(tb[2])
    ca, cb = ma.pop("chunk_accum"), mb.pop("chunk_accum")
    assert ma == mb
    np.testing.assert_array_equal(ca, cb)


def _layout(path):
    with np.load(str(path)) as z:
        return sorted(z.files), int(z["format"]), int(z["passes_done"])


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX-written mid-pass checkpoint loads in the port (the same
    arrays from either loader) and the port resumes it; a port-written one
    loads in the JAX package and JAX resumes it.  Each resumed image is
    within mean |diff| 1.0 of its writer's uninterrupted render (the
    packages' draws agree, their hit sweeps differ in the last bits)."""
    kw = dict(width=32, height=16, samples=16, seed=9, scheduler="persistent",
              rays_per_chunk=32 * 4 * 4)
    jcfg, tcfg = JC(backend="jnp", **kw), TC(**kw)
    j_part, t_part = tmp_path / "j.npz", tmp_path / "t.npz"
    assert JK.render_with_checkpoints(jax_test_scene(), None, jcfg, str(j_part),
                                      passes=1, max_chunks_per_run=2) is None
    assert _run(tcfg, t_part, passes=1, max_chunks_per_run=2) is None
    for path in (j_part, t_part):
        _loads_alike(path)
    assert _layout(j_part) == _layout(t_part)
    jfull = JK.render_with_checkpoints(jax_test_scene(), None, jcfg,
                                       str(tmp_path / "jf.npz"), passes=1)
    tfull = _run(tcfg, tmp_path / "tf.npz", passes=1)
    t_from_j = _run(tcfg, j_part, passes=1, chunk_checkpoints=True)
    j_from_t = JK.render_with_checkpoints(jax_test_scene(), None, jcfg,
                                          str(t_part), passes=1,
                                          chunk_checkpoints=True)
    for got, want in ((t_from_j, jfull), (j_from_t, tfull)):
        assert got.shape == (16, 32, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(float) - want.astype(float)).mean() <= 1.0
    # Finished files: the same keys, format 3 and pass count.
    assert _layout(tmp_path / "jf.npz") == _layout(tmp_path / "tf.npz")
    assert _layout(tmp_path / "tf.npz")[1:] == (3, 1)
