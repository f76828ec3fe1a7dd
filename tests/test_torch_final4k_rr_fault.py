"""Faults in the port's roulette that the limits of
``test_torch_final4k_rr.py`` catch, planted in the torch chain's scatter
(``persistent._scatter_core``, which the plain kernels B and B-multi run on
the CPU): the roulette without its 1 / p reweight darkens every path past
``rr_start_depth`` (``z_max``); p pinned at 0.05 keeps the image unbiased
but multiplies its survivors' weight by up to 20 (``noise_excess``).  This
file imports no JAX."""

from __future__ import annotations

import pytest
import torch

from win32_raytracer_tpu_torch import persistent as P
from win32_raytracer_tpu_torch.core.rng import hash_uniform01
from win32_raytracer_tpu_torch.ops.rows import scatter_rows

from test_torch_final4k_rr import LIMITS, numbers

torch.set_num_threads(1)


def _faulty_scatter(fault):
    """``persistent._scatter_core`` with ``fault`` in its roulette."""
    def scatter_core(st, rec, salt, step_i, dims, *, cfg, lean=False,
                     stats=None):
        n = st.origin.shape[1]
        draws = hash_uniform01((5, n), salt, step_i, 0x5CA77E12,
                               device=st.origin.device)
        sc = scatter_rows(st.direction, rec, draws, cfg)
        live = st.path_alive
        thr = torch.where(live, st.throughput * sc.attenuation, st.throughput)
        o = torch.where(live, sc.origin, st.origin)
        d = torch.where(live, sc.direction, st.direction)
        depth = torch.where(live, st.depth + 1, st.depth)
        alive = live & sc.alive & (depth <= dims.max_depth)
        if not lean:
            p = torch.clamp(thr.amax(dim=0, keepdim=True), 0.05, 1.0)
            if fault == "p_pinned":
                p = torch.full_like(p, 0.05)
            rr_on = alive & (depth >= dims.rr_start)
            if fault != "no_reweight":
                thr = torch.where(rr_on, thr / p, thr)
            alive = alive & torch.where(rr_on, draws[4:5] < p, True)
        return st._replace(origin=o, direction=d, throughput=thr, depth=depth,
                           path_alive=alive)
    return scatter_core


@pytest.fixture
def threads():
    """Four threads for these renders (the plain sphere sweep of the final
    scene; its result does not depend on the thread count,
    tests/test_torch_threads.py), then one again."""
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(1)


@pytest.mark.parametrize("fault,number", [("no_reweight", "z_max"),
                                          ("p_pinned", "noise_excess")])
def test_roulette_fault_fails(fault, number, monkeypatch, threads):
    monkeypatch.setattr(P, "_scatter_core", _faulty_scatter(fault))
    got = numbers()
    assert got[number] > LIMITS[number], got
