"""PyTorch port: the wavefront's column material scatter (ops/scatter.py)
against the JAX package's ``ops.scatter.scatter``, under every quirk
toggle.

The same seeded numpy hit records and draws go through both.  The ball
sample's radius is ``u^(1/3)`` in the port and ``cbrt(u)`` in the
reference, which can differ in the last place, and XLA's CPU code fuses
multiplies and adds; so a lane's outputs are held to rtol 1e-5 plus
atol 1e-5, and the lanes where a threshold decision (metal absorb,
Schlick reflect, total internal reflection) flips, or any output falls
outside that tolerance, are bounded to 0.2% (measured: 0 of 4,096 when
this test was written)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from win32_raytracer_tpu.config import RenderConfig as JC
from win32_raytracer_tpu.core.rng import sample_unit_ball as jax_ball
from win32_raytracer_tpu.ops.hit import HitRecord as JRec
from win32_raytracer_tpu.ops.scatter import scatter as jax_scatter
from win32_raytracer_tpu_torch.config import RenderConfig as TC
from win32_raytracer_tpu_torch.core.rng import sample_unit_ball
from win32_raytracer_tpu_torch.ops.hit import HitRecord
from win32_raytracer_tpu_torch.ops.scatter import ScatterResult, scatter

torch.set_num_threads(1)

N = 4096
QUIRKS = {
    "reference": {},
    "textbook": dict(refract_discriminant_bias=1.0, schlick_uses_ni_over_nt=False),
    "no reflect bias": dict(reflect_thres=0.0),
    "always refract": dict(reflect_thres=2.0),
    "schlick ior only": dict(schlick_uses_ni_over_nt=False),
    "bias only": dict(refract_discriminant_bias=1.0),
    "epsilon": dict(epsilon=1e-3),
}


def _inputs(seed):
    """A hit record of every material (unit normals of either sign as the
    sphere sweep gives them, glass of ior 1.5 and 1/1.5), incoming
    directions both into and out of the surface, and five draws."""
    r = np.random.default_rng(seed)
    nrm = r.normal(size=(N, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = r.normal(size=(N, 3)) * r.uniform(0.5, 3.0, (N, 1))
    rec = dict(
        hit=np.ones(N, bool), t=r.uniform(0.1, 9, N),
        point=r.uniform(-5, 5, (N, 3)), normal=nrm,
        idx=r.integers(0, 500, N).astype(np.int32),
        mat_id=r.integers(0, 3, N).astype(np.int32),
        albedo=r.uniform(size=(N, 3)), fuzz=r.uniform(0, 0.5, N),
        ior=np.where(r.uniform(size=N) < 0.8, 1.5, 1 / 1.5))
    rec = {k: v.astype(np.float32) if v.dtype == np.float64 else v
           for k, v in rec.items()}
    return rec, d.astype(np.float32), r.uniform(size=(N, 5)).astype(np.float32)


@pytest.mark.parametrize("quirk", sorted(QUIRKS))
def test_scatter_matches_reference(quirk):
    rec, d, u = _inputs(seed=len(quirk))
    kw = QUIRKS[quirk]
    ours = scatter(None, torch.from_numpy(d),
                   HitRecord(**{k: torch.from_numpy(v) for k, v in rec.items()}),
                   torch.from_numpy(u), TC(**kw))
    ref = jax_scatter(None, jnp.asarray(d),
                      JRec(**{k: jnp.asarray(v) for k, v in rec.items()}),
                      jnp.asarray(u), JC(**kw))
    assert isinstance(ours, ScatterResult)
    off = ours.alive.numpy() != np.asarray(ref.alive)
    for f in ("origin", "direction", "attenuation"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape == (N, 3) and a.dtype == np.float32
        off |= ~np.isclose(a, b, rtol=1e-5, atol=1e-5).all(axis=1)
    assert off.mean() <= 0.002, (quirk, off.sum())
    # Every material and branch is exercised.
    mats = rec["mat_id"]
    assert (~np.asarray(ref.alive)[mats == 1]).any()        # metal absorbs
    assert np.asarray(ref.alive)[mats != 1].all()


def test_quirk_toggles_change_glass_only():
    """The quirk toggles reach the dielectric branch and nothing else."""
    rec, d, u = _inputs(seed=99)
    args = (None, torch.from_numpy(d),
            HitRecord(**{k: torch.from_numpy(v) for k, v in rec.items()}),
            torch.from_numpy(u))
    base = scatter(*args, TC())
    text = scatter(*args, TC(**QUIRKS["textbook"]))
    glass = rec["mat_id"] == 2
    moved = (base.direction != text.direction).any(dim=1).numpy()
    assert moved[glass].any() and not moved[~glass].any()


def test_unit_ball_matches_reference():
    """u^(1/3) against cbrt: the points within 2 f32 epsilons."""
    u = np.random.default_rng(3).uniform(size=(20000, 3)).astype(np.float32)
    u[:4, 2] = [0.0, 1.0, 1e-30, 0.125]
    a = sample_unit_ball(torch.from_numpy(u)).numpy()
    b = np.asarray(jax_ball(jnp.asarray(u)))
    np.testing.assert_allclose(a, b, rtol=0, atol=2 * 2.0 ** -24)
    assert (np.linalg.norm(a, axis=1) <= 1.0 + 1e-6).all()
