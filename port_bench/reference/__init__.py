"""The plain references the benchmark holds the port to, one module a
reference, named by a configuration's ``reference`` (default ``render.py``)."""
