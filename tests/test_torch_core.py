"""PyTorch port: core/rng and core/materials against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu.core import materials as jmat
from win32_raytracer_tpu.core import rng as jrng
from win32_raytracer_tpu_torch.core import materials as tmat
from win32_raytracer_tpu_torch.core import rng as trng

torch.set_num_threads(1)


@pytest.mark.parametrize("salt", [0, 0xABC123, 0x80000001, 0xFFFFFFFF])
@pytest.mark.parametrize("step,purpose,shape", [
    (0, 0x5CA77E12, (5, 257)),
    (7, 0x2E59A301, (5, 1000)),
    (2 ** 31 - 1, 0x5CA77E12, (3, 64)),
    (123456, 0x1234, (1, 4096)),
])
def test_hash_uniform01_bit_exact(salt, step, purpose, shape):
    ours = trng.hash_uniform01(shape, salt, step, purpose).numpy()
    ref = np.asarray(jrng.hash_uniform01(
        shape, jnp.asarray(np.uint32(salt)), jnp.asarray(np.int32(step)),
        purpose))
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_reference_lcg_stream_equal():
    for seed in (666, 0, 2 ** 31 + 5):
        np.testing.assert_array_equal(trng.ReferenceLcg(seed).stream(300),
                                      jrng.ReferenceLcg(seed).stream(300))


def test_ball_and_disc_samplers():
    u = np.random.default_rng(3).uniform(0, 1, (2000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trng.sample_unit_ball(torch.from_numpy(u)).numpy(),
        np.asarray(jrng.sample_unit_ball(jnp.asarray(u))), atol=1e-6)
    np.testing.assert_allclose(
        trng.sample_unit_disc(torch.from_numpy(u[:, :2])).numpy(),
        np.asarray(jrng.sample_unit_disc(jnp.asarray(u[:, :2]))), atol=1e-6)


def _vecs(seed, n=1000):
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    eta = rng.uniform(0.5, 1.6, n).astype(np.float32)
    return d, nrm, eta


@pytest.mark.parametrize("bias", [2.0, 1.0])
def test_materials_match_reference(bias):
    d, nrm, eta = _vecs(4)
    td, tn, te = (torch.from_numpy(x) for x in (d, nrm, eta))
    jd, jn, je = (jnp.asarray(x) for x in (d, nrm, eta))
    np.testing.assert_allclose(tmat.reflect(td, tn).numpy(),
                               np.asarray(jmat.reflect(jd, jn)),
                               rtol=1e-6, atol=1e-6)
    r_t, ok_t = tmat.refract(td, tn, te, bias)
    r_j, ok_j = jmat.refract(jd, jn, je, bias)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6,
                               atol=1e-6)
    cos = np.clip(np.abs((d * nrm).sum(1)), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        tmat.schlick(torch.from_numpy(cos), te).numpy(),
        np.asarray(jmat.schlick(jnp.asarray(cos), je)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tmat.sky_color(td).numpy(),
                               np.asarray(jmat.sky_color(jd)), rtol=1e-6)


@pytest.mark.parametrize("quirks", [
    dict(),
    dict(refract_discriminant_bias=1.0, schlick_uses_ni_over_nt=False,
         reflect_thres=0.0),
])
def test_scatter_rows_matches_reference(quirks):
    """The rows scatter with the quirk toggles, on one set of hit records."""
    from win32_raytracer_tpu.config import RenderConfig as JC
    from win32_raytracer_tpu.ops import rows as jrows
    from win32_raytracer_tpu_torch.config import RenderConfig as TC
    from win32_raytracer_tpu_torch.ops import rows as trows

    n = 3000
    rng = np.random.default_rng(5)
    d, nrm, eta = _vecs(6, n)
    rec = dict(
        hit=np.ones((1, n), bool), t=np.ones((1, n), np.float32),
        point=rng.uniform(-3, 3, (3, n)).astype(np.float32),
        normal=nrm.T.copy(), idx=np.zeros((1, n), np.int32),
        mat_id=rng.integers(0, 3, (1, n)).astype(np.int32),
        albedo=rng.uniform(0, 1, (3, n)).astype(np.float32),
        fuzz=rng.uniform(0, 0.5, (1, n)).astype(np.float32),
        ior=(eta[None] + 0.5).astype(np.float32))
    draws = rng.uniform(0, 1, (5, n)).astype(np.float32)
    ours = trows.scatter_rows(
        torch.from_numpy(d.T.copy()),
        trows.HitRecordRows(**{k: torch.from_numpy(v) for k, v in rec.items()}),
        torch.from_numpy(draws), TC(**quirks))
    ref = jrows.scatter_rows(
        jnp.asarray(d.T), jrows.HitRecordRows(**{k: jnp.asarray(v)
                                                 for k, v in rec.items()}),
        jnp.asarray(draws), JC(**quirks))
    alive_t, alive_j = ours.alive.numpy(), np.asarray(ref.alive)
    assert (alive_t != alive_j).mean() < 1e-3
    for f in ("origin", "direction", "attenuation"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        close = np.isclose(a, b, rtol=1e-5, atol=1e-5).all(axis=0)
        assert close.mean() > 0.999, (f, close.mean())
