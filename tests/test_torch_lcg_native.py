"""PyTorch port: ``core/rng.ReferenceLcg`` against the native SSE2 oracle.

``native/lcg_check.cpp`` reproduces the reference's ``rand_sse``
(RayTracer.cpp:31-66) with real SSE2 intrinsics and prints the first N
rand4 vectors of a seed.  The port's host LCG builds the final scene, so
its stream must equal the oracle's bit for bit, not only the JAX
package's copy of it.  The oracle is built into a temporary directory;
the tests skip where no C++ compiler is found.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from win32_raytracer_tpu_torch.core import rng
from win32_raytracer_tpu_torch.scene.builders import random_scene

torch.set_num_threads(1)

SOURCE = os.path.join(os.path.dirname(__file__), "..", "native", "lcg_check.cpp")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Path of the compiled oracle (skips without a compiler)."""
    if not os.path.exists(SOURCE):
        pytest.skip("native/lcg_check.cpp missing")
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler found")
    exe = str(tmp_path_factory.mktemp("lcg") / "lcg_check")
    try:
        subprocess.run([cxx, "-O2", "-msse2", "-o", exe, SOURCE], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired) as e:
        pytest.skip(f"the oracle did not build: {e}")
    return exe


def native_stream(exe: str, seed: int, n: int) -> np.ndarray:
    out = subprocess.run([exe, str(seed), str(n)], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return np.array([[float(v) for v in ln.split()]
                     for ln in out.strip().splitlines()], np.float32)


@pytest.mark.parametrize("seed", [666, 1, 987654321, 0, 2 ** 31 - 1])
def test_reference_lcg_equals_native(oracle, seed):
    """Long streams, bit for bit: the default scene seed, the reference
    test's seeds, and the ends of the seed range."""
    want = native_stream(oracle, seed, 512)
    got = rng.ReferenceLcg(seed).stream(512)
    assert want.shape == (512, 4)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_final_scene_draws_come_from_the_native_stream(oracle):
    """The final scene's seed: its first draw is the oracle's first vector,
    and the scene it seeds builds the same spheres twice."""
    first = native_stream(oracle, 666, 1)[0]
    np.testing.assert_array_equal(rng.ReferenceLcg(666).rand4(), first)
    a, b = random_scene(seed=666), random_scene(seed=666)
    assert torch.equal(a.center1, b.center1) and torch.equal(a.radius, b.radius)
