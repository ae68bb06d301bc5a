"""A CUDA graph captured whole and cut at every span, to replay either.

A kernel launched by the replay of a CUDA graph carries the correlation
id of the ``cudaGraphLaunch`` that launched it, so a trace puts its work
in the host span around that launch. One graph for a whole band-frame
puts all of its kernels in the band-frame, below none of the layer spans
(``utils/spans.py``) that a trace's reader counts by. ``SpanGraph``
captures a function twice, into one memory pool: once as one graph, and
once cut, as a run of graphs: it ends a graph and begins the next at each
span's start and end (``spans.span`` hands it every span while it
captures) and keeps the spans, in their order, between the graphs. While
no profiler records, ``replay`` launches the one graph. While one does,
it launches the cut graphs in order and opens each span around them as
the capture met it, so a replayed kernel lies in the span of its eager
launch, a hand kernel in its ``pt::k:<kernel>`` span. A stretch with no
device work makes no graph that replays. Both forms run the same kernels
in the same order; the cut form costs a graph launch a stretch (one
band-frame of cornell: 93 graphs, 19 ms more a 12-band-frame pass on an
H100), which is why untraced replays take the whole graph.
"""

from __future__ import annotations

import warnings

import torch

from . import spans

# PyTorch's warning at the end of a capture that recorded no work
_EMPTY = "The CUDA Graph is empty"


class _Cut:
    """A span met by a capture: its start and its end each end the graph
    being captured, record the span's step and begin the next graph."""

    __slots__ = ("graph", "name")

    def __init__(self, graph: "SpanGraph", name: str):
        self.graph, self.name = graph, name

    def __enter__(self):
        self.graph._cut(self.name)

    def __exit__(self, kind, value, tb):
        if kind is None:  # an error ends the capture instead
            self.graph._cut(None)
        return False


class SpanGraph:
    """``capture(fn)`` once on ``device``, then ``replay()`` it any number
    of times on the current stream, between the same input tensors.

    ``steps``: the cut form in the capture's order: a span's name where it
    starts, None where the innermost open span ends, and the graphs that
    hold work; ``graphs``: those graphs alone."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)  # the captures'
        self.whole = None
        self.steps: list = []
        self.graphs: list = []
        # every graph begun, the empty ones too: each holds a share of
        # the pool, which its end would give back mid-capture
        self._all: list = []
        self._out = {}  # each form's result: its tensors in the pool
        self._pool = self._open = None

    def capture(self, fn) -> None:
        """Capture ``fn()`` on ``self.stream``: whole, then cut at its
        spans (``fn`` runs once under each capture). The caller runs
        ``fn`` eagerly on ``self.stream`` once before (the warm-up
        PyTorch's graph docs prescribe). The two forms share one memory
        pool: each replay writes every tensor of its own form that it
        reads, and their results stay apart."""
        torch.cuda.synchronize(self.device)
        self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(self.stream):
            for form in ("whole", "cut"):
                if form == "cut":
                    spans.capture = self._span
                try:
                    self._begin()
                    self._out[form] = fn()
                    self._end(keep=form == "cut")
                except BaseException:
                    self._abort()
                    raise
                finally:
                    spans.capture = None
        self.whole = self._all[0]

    def replay(self):
        """Launch the graph on the current stream and return ``fn``'s
        result, which the next replay rewrites: the whole graph, or, while
        a profiler records, the cut graphs in order inside the spans the
        capture met."""
        if not spans._recording():
            self.whole.replay()
            return self._out["whole"]
        opened = []
        for step in self.steps:
            if step is None:
                opened.pop().__exit__(None, None, None)
            elif isinstance(step, str):
                opened.append(torch.profiler.record_function(step))
                opened[-1].__enter__()
            else:
                step.replay()
        return self._out["cut"]

    def _span(self, name: str) -> _Cut:
        return _Cut(self, name)

    def _cut(self, step) -> None:
        self._end()
        self.steps.append(step)
        self._begin()

    def _begin(self) -> None:
        self._open = torch.cuda.CUDAGraph()
        self._all.append(self._open)
        self._open.capture_begin(pool=self._pool)

    def _end(self, keep: bool = True) -> None:
        """End the graph being captured; ``keep``: a step of the cut form
        where it holds work."""
        graph, self._open = self._open, None
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in said:
            if _EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if keep and not empty:
            self.steps.append(graph)
            self.graphs.append(graph)

    def _abort(self) -> None:
        """End a capture that failed, so the stream leaves capture mode."""
        graph, self._open = self._open, None
        if graph is not None:
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    graph.capture_end()
            except Exception:  # the capture was already invalid
                pass
        self.steps.clear()
        self.graphs.clear()
        self._out.clear()
