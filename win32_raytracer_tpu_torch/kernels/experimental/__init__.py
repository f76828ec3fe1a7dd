"""Layout adapters for the reference's experimental hit kernels
(``win32_raytracer_tpu/kernels/experimental/``): each module carries its
reference's name and entry point and runs on the hand kernel that computes
the same function (v1, v2: kernel G; v5: kernel A; the first sphere grid:
kernel I's column instance).  None takes ``interpret``: on the CPU the
kernels' plain versions run."""
