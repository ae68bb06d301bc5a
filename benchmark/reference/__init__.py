"""The benchmark's plain references: a module a kind of scene, named by
a configuration's ``reference`` key, with ``render_tiles(config,
traffic, view, tiles, frames, device, control=None)``. They import
numpy, torch and the standard library, and nothing of the program.

- ``diffuse_path``: diffuse triangles lit by area lights, Sobol, one
  light a vertex with one-sample MIS (``sobol.py``,
  ``mitsuba_scene.py``).
"""
