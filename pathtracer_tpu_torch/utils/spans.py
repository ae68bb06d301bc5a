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
  ``pt::sampler``, ``pt::camera``, ``pt::bounce`` and ``pt::film``;
- in a bounce: ``pt::intersect`` (a closest-hit or shadow query, alpha
  walks included), ``pt::shade`` (the hit's frame, emission, the
  material's parameters), ``pt::nee`` (one ``estimate_direct``),
  ``pt::scatter`` (the BSDF sample through Russian roulette);
- ``pt::texture`` (``eval_texture``), ``pt::alpha_cut`` and
  ``pt::k:<kernel>``, around the launch of a hand-written kernel.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; otherwise a shared ``nullcontext``."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)
