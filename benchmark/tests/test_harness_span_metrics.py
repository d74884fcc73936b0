"""The per-layer metrics that read the program's own spans
(`layer::<name>` ranges that `vosesam_tpu_torch.utils.profiling.span` opens
while a profiler runs), on hand-built traces: each reads the expected
milliseconds, and None when its span is missing, as on a program without
the spans."""

import pytest

import tiny  # noqa: F401
from harness import registry, tracing

BENCH = registry.benchmark()
SPAN_METRICS = ("xmem_host_ms_per_frame", "loop_host_ms_per_frame", "sync_wait_ms_per_frame",
                "click_host_ms", "click_sync_wait_ms")


def x(name, ts, dur, cat="user_annotation", **args):
    e = {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def span(name, a, b):
    return x(tracing.LABEL + name, a, b - a)


def kernels():
    """Two kernels, launched inside the first and second `xmem.step`."""
    return [x("cudaLaunchKernel", 800, 10, cat="cuda_runtime", correlation=1),
            x("cudaLaunchKernel", 3100, 10, cat="cuda_runtime", correlation=2),
            x("k_read", 1000, 1500, cat="kernel", correlation=1),
            x("k_decode", 3200, 2000, cat="kernel", correlation=2)]


# microseconds on the trace's clock; a window of 10 ms
TRACK = [span("track.loop", 100, 9000), span("track.upload", 100, 600),
         span("track.chunk", 600, 6000),
         span("xmem.step", 700, 3000), span("memory.read", 900, 1200),
         span("xmem.step", 3000, 5500), span("memory.read", 3100, 3300),
         span("track.masks", 5500, 5800),
         span("track.download", 6000, 7000), span("track.remap", 7000, 8500)]
CLICKS = [span("click.upload", 500, 1000), span("click.full", 1000, 4000),
          span("sam.decode", 1200, 2000), span("click.download", 4000, 4500),
          span("click.full", 5000, 7000), span("click.download", 7000, 7300)]


def view(spans, units, unit):
    events = [x(tracing.WINDOW, 0, 10000)] + spans + kernels()
    return tracing.TraceView(events, tracing.Ranges([]), units, unit, {}, None)


def read(name, tv):
    return registry.per_layer(name).read(tv)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_entries_read_program_spans_and_open_no_range(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span"
    assert registry.per_layer(name).LAYERS == ()


def test_tracking_metrics_read_their_spans():
    tv = view(TRACK, 8, "frames")
    assert read("xmem_host_ms_per_frame", tv) == pytest.approx(4.8 / 8)
    assert read("loop_host_ms_per_frame", tv) == pytest.approx((0.5 + 0.3 + 1.5) / 8)
    assert read("sync_wait_ms_per_frame", tv) == pytest.approx(1.0 / 8)
    assert read("click_host_ms", tv) is None and read("click_sync_wait_ms", tv) is None
    # an idle gap goes to the innermost program span open when it began:
    # both gaps after a kernel began inside an `xmem.step`
    gaps = dict(tv.idle_gaps)
    assert gaps["xmem.step"] == pytest.approx((3200 - 2500 + 10000 - 5200) * 1e-6)
    assert gaps["outside layers"] == pytest.approx(1000e-6)


def test_click_metrics_read_their_spans():
    tv = view(CLICKS, 2, "requests")
    assert read("click_host_ms", tv) == pytest.approx((3.0 + 2.0) / 2)
    assert read("click_sync_wait_ms", tv) == pytest.approx((0.5 + 0.3) / 2)
    for name in ("xmem_host_ms_per_frame", "loop_host_ms_per_frame", "sync_wait_ms_per_frame"):
        assert read(name, tv) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_without_the_span(name):
    unit = "requests" if name.startswith("click") else "frames"
    tv = view([span("track.chunk", 600, 6000), span("sam.decode", 1200, 2000)], 8, unit)
    assert read(name, tv) is None


def test_no_program_span_shares_a_wrapped_layer_name():
    """A span named like a file under `layers/` would merge into that
    layer's wrapped range and move the metrics that read it."""
    import os
    import re

    port = os.path.join(registry.ROOT, "vosesam_tpu_torch")
    names = set()
    for d, _, fs in os.walk(port):
        for f in fs:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    names |= set(re.findall(r'profiling\.span\("([^"]+)"\)', fh.read()))
    layers = {f[:-5] for f in os.listdir(os.path.join(registry.BENCH_DIR, "layers"))}
    assert {"xmem.step", "track.download", "click.full"} <= names
    assert not names & layers
