"""Rendering on several devices (``win32_raytracer_tpu.parallel``).

One process per device, SPMD: every rank calls the same render with a 1-D
:class:`torch.distributed.device_mesh.DeviceMesh` (axis ``"tiles"``, from
:func:`shard.make_mesh`) and gets the whole image back.  ``shard.py``
holds the mesh, the process-group set-up and the collectives, and the
wavefront's row and sample modes; ``persistent_shard.py`` the persistent
scheduler over the mesh; ``dryrun.py`` a launcher of gloo ranks on the
CPU.
"""
