"""pathtracer_tpu_torch — the PyTorch / CUDA port of ``pathtracer_tpu``.

Same module layout and function names as the JAX package, so
``pathtracer_tpu/X.py::f`` has its counterpart at
``pathtracer_tpu_torch/X.py::f``. Plain tensor code is PyTorch; the
TPU kernels on the ported paths are hand-written CUDA kernels for Hopper
(``csrc/``): the brute-force watertight intersection (K1,
``ops/cuda/intersect_cu.py``), the BVH32 traversal (K2,
``ops/cuda/bvhw_cu.py``) and the gather probes (``probes/``).
Every function takes its device from its input tensors or from an
explicit ``device`` argument; nothing here picks a device at import time,
and nothing imports JAX.

Layer map:
  core/      — math, sampling warps, camera, film, filters, the viewer's
               camera controllers
  ops/       — sobol, the stratified and random samplers, intersect (+
               cuda/ kernel wrappers and their shared nvcc build),
               interaction, bsdf, lights
  accel/     — binary SAH build (+ the native builder), BVH32 collapse
               and its plain traversal
  scene/     — Mitsuba XML and glTF importers, textures and the mip pool,
               procedural scenes → SceneData
  integrator — wavefront path integrator (fused bounce loop), with
               checkpoints and the occupancy counters
  integrator_lt — the adjoint light tracer
  parallel/  — data-parallel rendering over a torch.distributed group,
               one process a device (mesh.py)
  frontend/  — the command line (cli.py), the headless and interactive
               runners, the single-pixel debug trace, the tev protocol
  utils/     — image codecs, module-filtered logging
  interop    — the JAX package's SceneData / TracedScene → this package's
  probes/    — gather probes P1-P5 (gather.py) and P6-P9 (gather2.py)
"""

__version__ = "0.1.0"
