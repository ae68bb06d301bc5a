"""The span reader (``harness/spans.py``) and its four metrics, on
synthetic events, and on the CPU trace of a small render."""

import pytest

from harness import manifest, spans, trace

SPAN = (0, 1000)


def metric(name):
    return manifest.load_metric(name).compute


def band_frame(t0):
    """One band-frame from ``t0`` (100 ns): a sampler draw, the camera,
    one bounce (intersect with its hand kernel; shade with a texture
    lookup; nee with a shadow query; scatter; the bounce's own glue)
    and the film."""
    return [("pt::band_frame", t0, t0 + 100),
            ("pt::sampler", t0 + 1, t0 + 5),
            ("pt::camera", t0 + 5, t0 + 8),
            ("pt::bounce", t0 + 10, t0 + 80),
            ("pt::intersect", t0 + 11, t0 + 20),
            ("pt::k:intersect", t0 + 12, t0 + 14),
            ("pt::shade", t0 + 20, t0 + 30),
            ("pt::texture", t0 + 22, t0 + 26),
            ("pt::nee", t0 + 30, t0 + 50),
            ("pt::intersect", t0 + 40, t0 + 48),
            ("pt::k:intersect", t0 + 41, t0 + 43),
            ("pt::scatter", t0 + 50, t0 + 70),
            ("pt::sampler", t0 + 51, t0 + 53),
            ("pt::film", t0 + 85, t0 + 95)]


# host times of the torch ops' runtime calls in a band-frame, by layer
ISSUED = {"sampler": [2, 52], "camera": [6], "intersect": [15, 44],
          "shading": [24, 25, 31, 60, 75], "film": [90], "band_frame": [99]}


def synthetic(n_frames=2, hand_linked=False):
    """Spans, runtime calls and device operations of ``n_frames``
    band-frames in one chunk with its sync, inside SPAN; the hand
    kernels link by correlation only with ``hand_linked``."""
    sp = [("pt::chunk", 100, 100 + 110 * n_frames + 40)]
    runtime, device = {}, []
    corr = 1000
    for f in range(n_frames):
        t0 = 100 + 110 * f
        sp += band_frame(t0)
        for times in ISSUED.values():
            for dt in times:
                corr += 1
                runtime[corr] = t0 + dt
                device.append(("void at::native::elementwise_kernel<4>(x)",
                               t0 + dt + 3, t0 + dt + 4, corr))
        for launch in (12, 41):
            corr += 1
            if hand_linked:
                runtime[corr] = t0 + launch + 1
            device.append(("void intersect_kernel<false>(float const*)",
                           t0 + launch + 2, t0 + launch + 5, corr))
    t_sync = 100 + 110 * n_frames
    sp.append(("pt::chunk_sync", t_sync, t_sync + 30))
    # a copy issued in the sync; one operation whose runtime call the
    # trace lost; one operation before the traced span
    runtime[1] = t_sync + 2
    device.append(("Memcpy DtoH (Device -> Pageable)", t_sync + 5,
                   t_sync + 6, 1))
    device.append(("void at::native::reduce_kernel(x)", t_sync + 10,
                   t_sync + 11, 999999))
    device.append(("void at::native::elementwise_kernel<4>(x)", -50, -40, 2))
    runtime[2] = -60
    return device, runtime, sp


def test_runtime_calls_by_name():
    for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cuLaunchKernel",
                 "cudaLaunchKernelExC", "cudaMemsetAsync"):
        assert spans.RUNTIME.match(name), name
    for name in ("aten::mul", "pt::intersect", "cudnnConvolution",
                 "Memcpy DtoH (Device -> Pageable)"):
        assert not spans.RUNTIME.match(name), name


def test_correlation_links_a_torch_op_to_its_span():
    device, runtime, sp = synthetic(n_frames=1)
    times = [runtime.get(d[3]) for d in device]
    chains = spans.chains(sp, times)
    first = device.index(next(d for d in device if d[3] == 1001))
    assert times[first] == 102
    assert chains[first] == ("pt::chunk", "pt::band_frame", "pt::sampler")
    lost = next(i for i, d in enumerate(device) if d[3] == 999999)
    assert times[lost] is None and chains[lost] == ()


@pytest.mark.parametrize("linked", [False, True])
def test_hand_kernels_link_to_their_launch_spans(linked):
    """A hand kernel links by its launch's runtime call, inside its
    ``pt::k:`` span; one whose runtime call the trace lost links to
    nothing, and the check counts fewer kernels than launches."""
    device, runtime, sp = synthetic(n_frames=3, hand_linked=linked)
    got = spans.summarise(device, runtime, sp, SPAN)
    assert got["hand_launches"] == 6
    assert got["hand_kernels"] == (6 if linked else 0)
    times = [runtime.get(d[3]) for d in device]
    chains = spans.chains(sp, times)
    for i, d in enumerate(device):
        if d[0].startswith("void intersect_kernel"):
            if linked:
                assert chains[i][-2:] == ("pt::intersect",
                                          "pt::k:intersect")
                assert spans.layer_of(chains[i]) == "intersect"
            else:
                assert chains[i] == ()


def test_layer_rule():
    assert spans.layer_of(("pt::chunk", "pt::band_frame", "pt::bounce")) == \
        "shading"
    assert spans.layer_of(("pt::bounce", "pt::nee", "pt::intersect",
                           "pt::k:intersect")) == "intersect"
    assert spans.layer_of(("pt::bounce", "pt::shade", "pt::texture",
                           "pt::k:texture_eval")) == "shading"
    assert spans.layer_of(("pt::bounce", "pt::intersect", "pt::alpha_cut",
                           "pt::k:alpha_cut")) == "intersect"
    assert spans.layer_of(("pt::bounce", "pt::scatter", "pt::sampler")) == \
        "sampler"
    assert spans.layer_of(("pt::chunk", "pt::band_frame")) == "band_frame"
    assert spans.layer_of(()) == spans.OUTSIDE


def test_layers_sum_to_the_device_ops_of_the_trace():
    n = 4
    device, runtime, sp = synthetic(n_frames=n, hand_linked=True)
    got = spans.summarise(device, runtime, sp, SPAN)
    plain = trace.summarise([d[:3] for d in device], [], SPAN)
    assert sum(got["ops"].values()) == got["device_ops"] == \
        plain["device_ops"]
    want = {layer: n * len(t) for layer, t in ISSUED.items()}
    want["intersect"] += 2 * n  # the hand kernels
    want.update(chunk_sync=1, unlinked=1)
    assert got["ops"] == want
    assert got["in_band_frame"] == n * (sum(map(len, ISSUED.values())) + 2)
    assert got["band_frame_own"] == n
    assert got["hand_kernels"] == got["hand_launches"] == 2 * n
    assert got["band_frame_ms"] == pytest.approx([100e-6] * n)
    assert got["sync_s"] == pytest.approx(30e-9)
    assert got["span_s"] == pytest.approx(1000e-9)


def records(got, samples=4000):
    return dict(trace=dict(samples=samples, extra={"spans": got}))


def test_metrics_arithmetic():
    device, runtime, sp = synthetic(n_frames=3, hand_linked=True)
    sp.append(("pt::band_frame", 500, 530))  # a fourth, shorter one
    got = spans.summarise(device, runtime, sp, SPAN)
    rec = records(got)
    assert metric("host_ms_per_band_frame")(rec) == pytest.approx(100e-6)
    assert metric("sampler_ops_per_ksample")(rec) == pytest.approx(
        got["ops"]["sampler"] / 4.0)
    assert got["ops"]["sampler"] == 6
    assert metric("shading_ops_per_ksample")(rec) == pytest.approx(15 / 4.0)
    assert metric("sync_wait_pct")(rec) == pytest.approx(3.0)


def test_metrics_of_a_program_without_spans():
    device, runtime, _ = synthetic(n_frames=2)
    got = spans.summarise(device, runtime, [], SPAN)
    assert got["ops"] == {spans.OUTSIDE: len(device) - 2 - 2 * 2,
                          spans.UNLINKED: 1 + 2 * 2}
    assert got["hand_launches"] == got["hand_kernels"] == 0
    for name in ("host_ms_per_band_frame", "sampler_ops_per_ksample",
                 "shading_ops_per_ksample", "sync_wait_pct"):
        assert metric(name)(records(got)) is None
        assert metric(name)(dict(trace=None)) is None
        assert metric(name)(records(None)) is None


class FakeTracer:
    def __init__(self):
        self.on_close, self.extra = [], {}
        self.prof, self.done = None, False


def test_attach_registers_one_reader():
    tracer = FakeTracer()
    for name in ("host_ms_per_band_frame", "sampler_ops_per_ksample",
                 "shading_ops_per_ksample", "sync_wait_pct"):
        manifest.load_metric(name).attach(None, tracer)
    assert len(tracer.on_close) == 1
    tracer.on_close[0]()  # nothing traced: nothing read
    assert tracer.extra["spans"] is None


def test_a_cpu_render_trace():
    """The port's spans read from a real (CPU) trace: a render of two
    chunks, the second traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch.integrator import PathConfig, PathIntegrator
    from pathtracer_tpu_torch.scene.mitsuba import load_mitsuba

    cam, sd, _ = load_mitsuba(manifest.ROOT_DIR + "/data/cornell-box.xml",
                              resolution=(24, 16), device="cpu")
    integ = PathIntegrator(PathConfig(max_depth=2, mis_mode="onesample"),
                           spp=4, band_rows=12)
    tracer = FakeTracer()

    def callback(film, done):
        if done == 2:
            tracer.prof = profile(activities=[ProfilerActivity.CPU])
            tracer.prof.start()
            tracer.span = torch.profiler.record_function(trace.SPAN)
            tracer.span.__enter__()
        else:
            tracer.span.__exit__(None, None, None)
            tracer.prof.stop()
            tracer.done = True

    spans.attach(tracer)
    integ.render_progressive(cam, sd, chunk_spp=2, callback=callback)
    tracer.on_close[0]()
    got = tracer.extra["spans"]
    _, n_bands = integ.band_layout(cam)
    assert len(got["band_frame_ms"]) == 2 * n_bands
    assert got["sync_s"] > 0
    assert got["device_ops"] == 0  # the CPU runs no device operation
    assert metric("host_ms_per_band_frame")(records(got)) > 0
    assert metric("sync_wait_pct")(records(got)) > 0
