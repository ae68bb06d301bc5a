"""Named host ranges of the render loop, on the profiler's own timeline.

``span(name)`` is a ``torch.profiler.record_function`` range
while a torch profiler records, and one shared do-nothing context
otherwise: the spans exist exactly while a profiler runs (the CLI's
``--profile``, a benchmark's traced passes) and cost one check of the
profiler's state each when none does. They are Kineto ranges, so they
share the clock and the timeline of the device's kernels: each kernel's
launch, and each gap the device waits in, lies inside the span the host
was in. The port keeps no timestamps of its own; whoever runs the
profiler reads or writes its events.

The spans (``pt::`` names; parent by nesting):

- ``pt::chunk``: one chunk of ``render_progressive``; in it
  ``pt::chunk_sync`` (the chunk's host reads of its counts, the
  occupancy read, the checkpoint save) and ``pt::callback``;
- ``pt::band_frame``: one row band's one sample frame; in it
  ``pt::sampler``, ``pt::camera``, ``pt::bounce`` and ``pt::film``.
  Where the band-frame runs as CUDA graphs (``integrator._BandGraph``)
  they lie in ``pt::graph_capture`` (the eager warm-up and the captures,
  once a graph) or ``pt::graph_replay`` (a replay). A replay under a
  profiler opens the spans its capture met, in their order, and launches
  each stretch of device work between two of them as a graph of its own
  (``utils/span_graph.py``): a replayed kernel's correlation id names a
  ``cudaGraphLaunch`` in the span its eager launch would lie in;
- in a bounce: ``pt::intersect`` (a closest-hit or shadow query, alpha
  walks included), ``pt::shade`` (the hit's frame, emission, the
  material's parameters), ``pt::nee`` (one ``estimate_direct``),
  ``pt::scatter`` (the BSDF sample through Russian roulette);
- ``pt::texture`` (``eval_texture``), ``pt::alpha_cut`` and
  ``pt::k:<kernel>``, around the launch of a hand-written kernel;
- ``pt::light``: each call of ``ops/lights.py``'s ``sample_li`` (the light
  sample of ``integrator.estimate_direct``, in ``pt::nee``) and ``pdf_li``
  (the light's density along a BSDF direction, in ``pt::nee``, and along
  the ray that hit an area light, in ``pt::shade``), whatever the light.
  The benchmark's ``light_ops_per_ksample`` reads it;
- ``pt::env``: each call of the environment light's code
  (``ops/lights.py``: ``env_le``, ``env_pdf_li``, ``_env_sample_li``),
  which only a scene with an environment makes: the escaped rays' radiance
  and density in ``pt::shade``, the light's sample in ``pt::nee``. The
  benchmark's ``env_ops_per_ksample`` reads it;
- on the card, kernels K5 and K6 (``ops/cuda/bsdf_cu.py``) evaluate the
  BSDF in ``pt::nee`` and sample it in ``pt::scatter``: each launch in its
  ``pt::k:bsdf_eval`` / ``pt::k:bsdf_sample``, and, where the scene holds
  METAL, SUBSTRATE or GLASS, inside one ``pt::bsdf:kernel`` (a scene of
  MATTE alone, such as cornell, opens none). The benchmark's
  ``bsdf_ops_per_ksample`` reads the ``pt::bsdf:`` prefix.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
# while a ``span_graph.SpanGraph`` captures, the function that makes its
# spans (each cuts the capture: ``SpanGraph._span``); else None
capture = None


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; otherwise a shared ``nullcontext``. While a ``SpanGraph``
    captures, its own span, which records the span in the capture."""
    if capture is not None:
        return capture(name)
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)
