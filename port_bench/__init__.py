"""The benchmark of ``win32_raytracer_tpu_torch`` (the PyTorch and CUDA
port).  ``run.py`` is the command; see README.md."""
