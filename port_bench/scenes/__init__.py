"""Scene inputs the benchmark makes itself, one module per scene, found by
name (``cells.load_scene``).  Each module's ``build()`` returns a dict:

* ``"spheres"``: the sphere arrays in the port's ``SphereScene`` layout
  (``center1 center2 t1 t2 radius mat_id albedo fuzz ior active``), padded
  to a multiple of 128 rows with inactive rows parked far below the scene,
  as the port's ``scene_from_numpy`` takes them;
* ``"triangles"``: the triangle arrays in the ``TriangleScene`` layout
  (``v0 e1 e2 mat_id albedo fuzz ior active``), padded the same way, or
  None.

The same arrays go to the port and to the plain reference
(``reference/render.py``), which reads only the active rows.
"""
