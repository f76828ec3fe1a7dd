"""win32_raytracer_tpu_torch — the path tracer on PyTorch and CUDA.

The PyTorch port of ``win32_raytracer_tpu`` (the JAX package, which stays
the reference).  Plain tensor code is torch; the kernels of the render's
hot path are CUDA C++ written for Hopper (``csrc/``), built with nvcc on
first use.  This package never imports jax or the JAX package.
"""

import torch

# A float32 matmul or convolution may run in TF32 (about three decimal
# digits) on a card.  The renderer contracts nothing through cuBLAS/cuDNN
# on its path, but its results are compared to an f32 reference at 1e-5,
# so any contraction that appears must run in full f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .animation import orbit_path, render_animation  # noqa: E402
from .api import RenderResult, render, render_async  # noqa: E402
from .config import RenderConfig  # noqa: E402
from .scene.builders import SCENES, get_scene  # noqa: E402

__all__ = ["RenderConfig", "RenderResult", "SCENES", "get_scene",
           "orbit_path", "render", "render_animation", "render_async"]
