"""``utils/span_graph.SpanGraph`` on the CPU, with stand-ins for CUDA.

The captures' cuts and the replay's spans need no card: a stand-in graph
class records the "device work" (calls of ``op``) issued while it
captures, says "empty" as PyTorch does for a capture with none, and
logs its ops when replayed. A body of nested spans is captured whole and
cut; without a profiler a replay runs the whole graph and opens no span;
under a stand-in profiler it runs the cut graphs, and the log equals the
body's eager run: each op inside the spans of its eager launch. The real
graphs are held to the eager path on the card in
``tests/test_torch_cuda_graph.py``.
"""

import contextlib
import warnings

import pytest
import torch

from pathtracer_tpu_torch.utils import span_graph, spans
from pathtracer_tpu_torch.utils.spans import span

LOG = []


class FakeGraph:
    capturing = None  # the graph being captured

    def __init__(self):
        self.ops = []

    def capture_begin(self, pool=None):
        assert FakeGraph.capturing is None and pool == "pool"
        FakeGraph.capturing = self

    def capture_end(self):
        FakeGraph.capturing = None
        if not self.ops:
            warnings.warn("The CUDA Graph is empty. This usually means that "
                          "the graph was attempted to be captured on wrong "
                          "device or stream.")

    def replay(self):
        LOG.extend(self.ops)


def op(name):
    """Device work: captured by the open graph, else run (logged)."""
    if FakeGraph.capturing is not None:
        FakeGraph.capturing.ops.append(name)
    else:
        LOG.append(name)


class FakeRange:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        LOG.append(("enter", self.name))
        return self

    def __exit__(self, *exc):
        LOG.append(("exit", self.name))


RUNS = []  # one result a run of ``body``


def body():
    op("a")
    with span("pt::x"):
        op("b")
        with span("pt::y"):
            pass
        with span("pt::k:z"):
            op("c")
    op("d")
    RUNS.append(object())
    return RUNS[-1]


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "stream")
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.profiler, "record_function", FakeRange)
    LOG.clear()
    RUNS.clear()
    yield
    FakeGraph.capturing = None
    spans.capture = None


def _recording(monkeypatch, on):
    monkeypatch.setattr(spans, "_recording", lambda: on)


def test_capture_cuts_at_every_span_and_drops_empty_stretches(
        fake_cuda, monkeypatch):
    """The whole graph holds all the work; the cut form a graph a
    stretch of work between two spans, the spans in their order between
    them; a stretch without work (in ``pt::y``, between two span ends)
    makes no graph, and nothing ran while capturing."""
    _recording(monkeypatch, False)
    g = span_graph.SpanGraph("cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the empty captures' warnings
        g.capture(body)  # are taken, not shown
    assert LOG == [] and spans.capture is None and len(RUNS) == 2
    assert g.whole.ops == ["a", "b", "c", "d"]
    kinds = [s if s is None or isinstance(s, str) else tuple(s.ops)
             for s in g.steps]
    assert kinds == [("a",), "pt::x", ("b",), "pt::y", None, "pt::k:z",
                     ("c",), None, None, ("d",)]
    assert [tuple(x.ops) for x in g.graphs] == [("a",), ("b",), ("c",),
                                                ("d",)]


@pytest.mark.parametrize("profiled", [False, True])
def test_replay_gives_the_eager_log(fake_cuda, monkeypatch, profiled):
    """Replayed, the graphs run the body's work in its order, and return
    the result of their own form's capture; under a profiler the cut
    graphs, inside the spans of the body's eager run, as that run nests
    them; without one the whole graph, with no span at all."""
    _recording(monkeypatch, False)
    g = span_graph.SpanGraph("cuda")
    g.capture(body)
    whole, cut = RUNS
    _recording(monkeypatch, profiled)
    body()
    eager = list(LOG)
    LOG.clear()
    got = [g.replay(), g.replay()]
    assert LOG == eager * 2
    assert got == ([cut, cut] if profiled else [whole, whole])
    want = ["a", "b", "c", "d"]
    if profiled:
        want = ["a", ("enter", "pt::x"), "b", ("enter", "pt::y"),
                ("exit", "pt::y"), ("enter", "pt::k:z"), "c",
                ("exit", "pt::k:z"), ("exit", "pt::x"), "d"]
    assert eager == want


def test_a_failed_capture_ends_cleanly(fake_cuda, monkeypatch):
    """An error inside the captured function, in the whole capture or in
    the cut one, ends the open capture, leaves no graph to replay and no
    capture hook, and reaches the caller."""
    _recording(monkeypatch, False)

    def bad(cut_only):
        op("a")
        with span("pt::x"):
            if spans.capture is not None or not cut_only:
                raise RuntimeError("operation not permitted when stream "
                                   "is capturing")

    for cut_only in (False, True):
        g = span_graph.SpanGraph("cuda")
        with pytest.raises(RuntimeError, match="capturing"):
            g.capture(lambda: bad(cut_only))
        assert FakeGraph.capturing is None and spans.capture is None
        assert g.steps == [] and g.graphs == [] and g.whole is None
    with span("pt::after") as s:  # spans are spans again
        assert s is None
