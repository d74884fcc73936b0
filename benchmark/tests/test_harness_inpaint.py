"""The `inpaint.window` cell's own pieces on the CPU, at sizes a test can
hold: the masks, the seed-drawn start of the cycle, the warm-up, the probes
and the roofline functions that read them, the metrics that read the
program's spans and the kernel records, the check's exact composite outside
the mask and its rebuilt composite inside it, the plain reference's
isolation, and the bfloat16 control failing a limit. Nothing here edits the
harness it tests."""

import ast
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from harness import registry, system, tracing

SEED = 2**37 + 11
H, W = 96, 200          # padded by the inpainter to 120x216: a 10x18 token grid


def cell():
    bench = registry.benchmark()
    wl = registry.workload(bench, "inpaint.window")
    cfg = copy.deepcopy(registry.config(bench, wl["config"]))
    cfg["memory"].update(max_mid_term_frames=3, min_mid_term_frames=2,
                         max_long_term_elements=64, num_prototypes=8, top_k=8, mem_every=2)
    cfg["e2fgvi"]["num_blocks"] = 1
    spec = copy.deepcopy(registry.traffic(wl["traffic"]))
    spec.update(height=H, width=W, videos=[[13, 1], [12, 2]],
                check={"calls": 1, "within": 2}, trace={"calls": 1})
    return bench, wl, cfg, spec


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drv():
    _, _, cfg, spec = cell()
    sysm = system.build(cfg, SEED, torch.device("cpu"))
    return registry.driver(spec["kind"]).Driver(sysm, spec, SEED)


def test_masks_cover_exactly_the_painted_rectangles():
    from traffic import frames as FR

    mod = registry.driver("inpaint")
    for n, o, seed in ((20, 3, 5), (9, 5, 6)):
        fr = FR.multi_object_frames(n, 480, 854, o, seed=seed)
        base = np.random.default_rng(seed).integers(0, 255, (480, 854, 3), np.uint8)
        masks = mod.object_masks(n, 480, 854, o)
        colors = np.asarray(FR.OBJ_COLORS[:o], np.uint8)
        painted = (fr != base[None]).any(-1)
        assert not (painted & ~masks).any()
        inside = fr[masks]
        assert (inside[:, None, :] == colors[None]).all(-1).any(-1).all()


def test_the_cycle_starts_at_a_seeded_video_and_visits_every_video():
    _, _, cfg, spec = cell()
    spec["videos"] = [[13, 1], [27, 2], [14, 1], [15, 3], [12, 1]]
    sysm = system.build(cfg, SEED, torch.device("cpu"))
    mod = registry.driver(spec["kind"])
    starts = set()
    for seed in (SEED, SEED + 1, SEED + 2, 2**40 + 3, 5, 6, 7):
        d = mod.Driver(sysm, spec, seed)
        assert [d.call(i).video for i in range(5)] == [(d.start + i) % 5 for i in range(5)]
        assert mod.Driver(sysm, spec, seed).start == d.start
        starts.add(d.start)
    assert len(starts) > 1


def test_warm_up_covers_every_window_shape(monkeypatch):
    """With the generator stood in for by zeros of its output's shape: the
    (slots, local frames) of every generator call in a cycle of the
    traffic's videos, subsets split, were warmed up."""
    from vosesam_tpu_torch.models.e2fgvi import generator as G

    _, _, cfg, spec = cell()
    spec["videos"] = [[13, 1], [27, 2], [52, 1], [61, 3], [12, 1]]
    seen = []

    def stub(net, masked, num_local, cfg_, frame_valid=None, remat=False):
        seen.append((int(masked.shape[-4]), int(num_local), tuple(masked.shape[-3:-1])))
        fl = masked.new_zeros((*masked.shape[:-4], num_local - 1,
                               masked.shape[-3] // 4, masked.shape[-2] // 4, 2))
        return torch.zeros_like(masked), (fl, fl)

    sysm = system.build(cfg, SEED, torch.device("cpu"))
    d = registry.driver(spec["kind"]).Driver(sysm, spec, SEED)
    monkeypatch.setattr(G, "generator_forward", stub)
    d.warm_up()
    warmed = set(seen)
    seen.clear()
    for i in range(len(d.cycle)):
        d.run(d.call(i))
    assert set(seen) <= warmed
    assert len({s[0] for s in seen}) >= 3        # the videos give several shapes


def test_probes_record_what_the_rooflines_read():
    from roofline.deform_align import deform_bound_s
    from roofline.inpaint import GeneratorFlops
    from vosesam_tpu_torch.config import InpainterConfig
    from vosesam_tpu_torch.models.e2fgvi import generator as G

    _, _, cfg, _ = cell()
    ranges = tracing.Ranges(["e2fgvi_generator", "deform_align"])
    ranges.install()
    try:
        net = G.generator_init(InpainterConfig(num_blocks=1), seed=1, device="cpu")
        x = torch.zeros((1, 7, 60, 108, 3))
        valid = torch.tensor([[True] * 6 + [False]])
        ranges.active = True
        with torch.no_grad():
            G.generator_forward(net, x, 5, InpainterConfig(num_blocks=1), frame_valid=valid)
        ranges.active = False
    finally:
        ranges.undo()
    (gen,) = ranges.records["e2fgvi_generator"]
    assert {k: gen[k] for k in ("b", "t", "num_local", "h", "w")} == \
        {"b": 1, "t": 7, "num_local": 5, "h": 60, "w": 108}
    assert registry.probe("e2fgvi_generator").valid_counts(gen) == [6]
    flops = GeneratorFlops(cfg)
    assert flops.window(6, 5, 60, 108) > flops.window(5, 5, 60, 108) > 0
    deform = ranges.records["deform_align"]
    assert len(deform) == 2 * (5 - 1)          # two directions, one per frame after the first
    for p in deform:
        assert (p["b"], p["h"], p["w"], p["cin"], p["groups"], p["itemsize"]) == \
            (1, 15, 27, 256, 16, 4)
        assert deform_bound_s(p["b"], p["h"], p["w"], p["cin"], p["groups"], 3.35e12) > 0


def test_deform_roofline_reproduces_the_b6_bound_of_perf_md():
    """PERF.md's kernel table: B6's bound at x (1, 60, 108, 256), 16 groups,
    is 0.0232 ms (bytes) at the H100's 3.35 TB/s."""
    from roofline.deform_align import deform_bound_s, deform_bytes

    assert deform_bytes(1, 60, 108, 256, 16) == 4 * 6480 * (256 + 288 + 144 + 9 * 256)
    assert round(deform_bound_s(1, 60, 108, 256, 16, 3.35e12) * 1e3, 4) == 0.0232


def x(name, ts, dur, cat="user_annotation", **args):
    e = {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def test_span_metrics_read_the_transformer_and_nothing_without_it():
    events = [x(tracing.WINDOW, 0, 10000),
              x(tracing.LABEL + "inpaint.video", 100, 9000),
              x(tracing.LABEL + "e2fgvi.transformer", 1000, 2000),
              x("cudaLaunchKernel", 1100, 10, cat="cuda_runtime", correlation=1),
              x("cudaLaunchKernel", 4000, 10, cat="cuda_runtime", correlation=2),
              x("k_attn", 1200, 1500, cat="kernel", correlation=1),
              x("k_dec", 4100, 500, cat="kernel", correlation=2)]
    tv = tracing.TraceView(events, tracing.Ranges([]), 10, "frames", {}, None)
    assert registry.per_layer("focal_ms_per_frame").read(tv) == pytest.approx(1.5 / 10)
    assert registry.per_layer("device_idle.inpaint").read(tv) == pytest.approx(80.0)
    bare = tracing.TraceView([e for e in events if "transformer" not in e["name"]],
                             tracing.Ranges([]), 10, "frames", {}, None)
    assert registry.per_layer("focal_ms_per_frame").read(bare) is None
    for name in ("e2fgvi_ms_per_frame", "deform_align_roofline", "step_mfu.inpaint"):
        assert registry.per_layer(name).read(bare) is None


@pytest.mark.parametrize("name,span", [("inpaint_sync_wait_ms_per_frame", "inpaint.download"),
                                       ("propagate_host_ms_per_frame", "e2fgvi.propagate"),
                                       ("flow_host_ms_per_frame", "e2fgvi.flow")])
def test_host_span_metrics_read_their_span_and_nothing_without_it(name, span):
    events = [x(tracing.WINDOW, 0, 10000), x(tracing.LABEL + span, 1000, 2500),
              x("cudaLaunchKernel", 1100, 10, cat="cuda_runtime", correlation=1),
              x("k", 1200, 1500, cat="kernel", correlation=1)]
    tv = tracing.TraceView(events, tracing.Ranges([]), 10, "frames", {}, None)
    assert registry.per_layer(name).read(tv) == pytest.approx(2.5 / 10)
    bare = tracing.TraceView(events[:1] + events[2:], tracing.Ranges([]), 10, "frames", {}, None)
    assert registry.per_layer(name).read(bare) is None


def test_launches_per_frame_counts_the_windows_kernel_records():
    events = [x(tracing.WINDOW, 0, 10000)] + [
        x("k", 100 * i, 50, cat="kernel", correlation=i) for i in range(1, 7)]
    tv = tracing.TraceView(events, tracing.Ranges([]), 4, "frames", {}, None)
    assert registry.per_layer("launches_per_frame.inpaint").read(tv) == pytest.approx(6 / 4)
    empty = tracing.TraceView(events[:1], tracing.Ranges([]), 4, "frames", {}, None)
    assert registry.per_layer("launches_per_frame.inpaint").read(empty) is None


class _KeepLastWindow:
    """`torch` as the pipeline sees it, with a composite that keeps a
    frame's last window instead of blending it with the earlier one."""

    @staticmethod
    def where(cond, blended, last):
        return last

    def __getattr__(self, name):
        return getattr(torch, name)


def test_composite_inside_gap_is_zero_and_sees_a_blend_that_keeps_the_last_window(
        drv, monkeypatch):
    from vosesam_tpu_torch.pipeline import inpaint as I

    cpu = torch.device("cpu")
    drv._composite_taken = False
    cap = drv.run_captured(drv.cycle[0])
    assert len(cap["subsets"]) == 1 and cap["subsets"][0]["preds"]
    assert drv._composite_inside_gap(cap, cpu) == 0.0
    assert drv.run_captured(drv.cycle[0])["subsets"] is None    # the first sampled call only
    drv._composite_taken = False
    monkeypatch.setattr(I, "torch", _KeepLastWindow())
    assert drv._composite_inside_gap(drv.run_captured(drv.cycle[0]), cpu) > 0.0


def test_composite_gap_sees_one_changed_pixel_outside_the_mask(drv):
    out = list(drv.videos[0]["frames"].copy())
    cap = {"video": 0, "out": out}
    assert drv._composite_gap(cap, torch.device("cpu")) == 0.0
    outside = np.argwhere(~drv.masks[0][0])[0]
    out[0][outside[0], outside[1], 0] ^= 1
    assert drv._composite_gap(cap, torch.device("cpu")) == 1.0
    cap["out"] = out[:-1]
    assert drv._composite_gap(cap, torch.device("cpu")) == float("inf")


def _imports(path):
    for n in ast.walk(ast.parse(open(path).read())):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module and n.level == 0:
            yield n.module


def test_the_e2fgvi_reference_imports_what_the_isolation_test_allows():
    allowed = ("plainref", "torch", "numpy", "math", "typing", "dataclasses", "functools",
               "__future__")
    top = os.path.join(tiny.BENCH, "reference", "plainref", "models", "e2fgvi")
    found = [m for f in sorted(os.listdir(top)) if f.endswith(".py")
             for m in _imports(os.path.join(top, f))]
    assert found and all(m.split(".")[0] in allowed for m in found), found
    code = ("import sys; sys.path.insert(0, 'reference'); "
            "import plainref.models.e2fgvi.generator; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vosesam_tpu', 'vosesam_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.BENCH, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_bfloat16_control_fails_a_limit_and_the_program_passes():
    import control

    _, _, cfg, spec = cell()
    line = control.readings("inpaint.window", SEED, torch.device("cpu"), cfg, spec)
    json.dumps(line)
    lim = registry.limits("inpaint.window")["numbers"]
    prog, ctrl = line["program"], line["control"]
    assert set(lim) <= set(prog) and line["failed"] == 0
    assert all(prog[k] <= v["limit"] for k, v in lim.items()), prog
    assert any(ctrl[k] > v["limit"] for k, v in lim.items()), ctrl
