"""The program's profiler spans (`utils/profiling.span`) on the CPU, at the
TINY SAM of `tests/test_torch_interact.py` and a small memory whose
long-term consolidation fires within a dozen 48x64 frames:

  - under `profiling.trace`, one session (annotation `Tracker.track`,
    `track_batch` with refinement on: two chunks and a remainder frame, a
    per-frame `track`, then `first_frame_click`) writes every span as
    `layer::<name>` in the `user_annotation` category, each inside the
    span that calls it;
  - with no profiler running `span` returns one shared null context and
    `record_function` is never entered;
  - masks, scores, logits and the click's answers are bit-equal with the
    profiler on and off.
"""

import json

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import (
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.pipeline import track_anything as tta
from vosesam_tpu_torch.utils import profiling

H, W = 48, 64
N_FRAMES = 11
TINY = dict(model_type="vit_b", image_size=128, window_size=7,
            vit_dims=(("vit_b", 64, 2, 2, (1,)),))
POINTS = np.array([[20.0, 15.0], [50.0, 40.0], [22.0, 16.0]])
LABELS = np.array([1, 0, 1])

# each span, and the spans it may sit in (None: at the top of a call)
PARENTS = {
    "track.loop": {None, "track.loop"},
    "track.upload": {"track.loop"},
    "track.chunk": {"track.loop"},
    "track.masks": {"track.loop", "track.chunk"},
    "track.download": {"track.loop"},
    "track.remap": {"track.loop"},
    "xmem.step": {"track.loop", "track.chunk"},
    "xmem.encode_key": {"xmem.step"},
    "memory.read": {"xmem.step"},
    "xmem.segment": {"xmem.step"},
    "xmem.memorize": {"xmem.step"},
    "memory.consolidate": {"xmem.memorize"},
    "sam.encode": {"track.loop", "track.chunk", None},
    "sam.global_attention": {"sam.encode"},
    "refine": {"track.loop", "track.chunk"},
    "refine.prompts": {"refine"},
    "sam.decode": {"refine", "click.full"},
    "click.full": {None},
    "click.upload": {None},
    "click.download": {None},
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _clip():
    r = np.random.default_rng(0)
    base = r.integers(0, 255, (H, W, 3), np.uint8)
    frames = []
    for i in range(N_FRAMES):
        f = base.copy()
        f[6 + i:18 + i, 4 + 2 * i:20 + 2 * i] = (220, 60, 60)
        f[30:42, 44 - i:58 - i] = (60, 200, 220)
        frames.append(f)
    seed = np.zeros((H, W), np.uint8)
    seed[6:18, 4:20] = 1
    seed[30:42, 44:58] = 2
    return frames, seed


def _session(ta, frames, seed):
    """Annotation frame, two chunks of 4 and a remainder frame, one more
    frame on its own, then a two-pass click on a fresh image."""
    ta.xmem.clear_memory()
    m0, lg0, _p0, s0 = ta.xmem.track(frames[0], seed)
    masks, scores = ta.xmem.track_batch(frames[1:N_FRAMES - 1], chunk=4)
    m1, lg1, _p1, s1 = ta.xmem.track(frames[-1])
    ta.samcontroler.reset_image()
    c_mask, c_logit, c_painted = ta.first_frame_click(frames[0], POINTS, LABELS)
    return {"masks": np.stack([m0] + masks + [m1]),
            "scores": np.asarray([(i, v) for i, s in enumerate([s0] + scores + [s1])
                                  for v in s], np.float64),
            "logits": np.stack([lg0, lg1]),
            "click_mask": c_mask, "click_logit": c_logit, "click_painted": c_painted}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = FrameworkConfig(
        xmem=XMemConfig(max_objects=2),
        memory=MemoryConfig(max_mid_term_frames=3, min_mid_term_frames=2,
                            max_long_term_elements=64, num_prototypes=8, top_k=8,
                            mem_every=2),
        sam=SAMConfig(**TINY),
        refinement=RefinementConfig(use_refinement=True, mode="both_neg",
                                    min_region_area=10.0),
        dtype="float32")
    ta = tta.TrackingAnything(cfg=cfg, device="cpu")
    frames, seed = _clip()
    off = _session(ta, frames, seed)
    logdir = tmp_path_factory.mktemp("trace")
    with profiling.trace(str(logdir)):
        on = _session(ta, frames, seed)
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith(profiling.LABEL):
            assert e.get("cat") == "user_annotation", e
            spans.setdefault(name[len(profiling.LABEL):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return {"ta": ta, "frames": frames, "seed": seed, "off": off, "on": on, "spans": spans}


def _inside(child, parent, eps=0.5):
    return parent[0] - eps <= child[0] and child[1] <= parent[1] + eps


def test_the_flag_follows_the_profiler():
    """`span` reads the flag that a `torch.profiler` session sets while it
    runs, as the benchmark starts one (`profile().start()`)."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False and profiling.span("xmem.step") is profiling._NULL
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert flag() is True
        assert isinstance(profiling.span("xmem.step"), torch.profiler.record_function)
    finally:
        prof.stop()
    assert flag() is False and profiling.span("xmem.step") is profiling._NULL


def test_no_profiler_no_range(runs, monkeypatch):
    """Off, every span is the one null context, and the program runs with
    `record_function` made to raise."""
    assert profiling.span("track.loop") is profiling.span("memory.read")
    assert isinstance(profiling.span("click.full"), type(profiling._NULL))

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    out = _session(runs["ta"], runs["frames"], runs["seed"])
    np.testing.assert_array_equal(out["masks"], runs["off"]["masks"])


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_every_span_is_in_the_trace_inside_its_caller(runs, name):
    spans = runs["spans"]
    assert spans.get(name), f"no layer::{name} in the trace"
    for iv in spans[name]:
        inside = {p for p in PARENTS[name] - {None}
                  if any(_inside(iv, piv) for piv in spans.get(p, []) if piv != iv)}
        assert inside or None in PARENTS[name], (name, iv)


def test_the_chunk_nests_the_step_and_the_step_the_read(runs):
    spans = runs["spans"]
    chunks, steps, loops = spans["track.chunk"], spans["xmem.step"], spans["track.loop"]
    assert all(any(_inside(c, lp) for lp in loops) for c in chunks)
    assert sum(any(_inside(s, c) for c in chunks) for s in steps) == 8
    assert all(any(_inside(r, s) for s in steps) for r in spans["memory.read"])
    assert len(steps) == len(spans["memory.read"]) == N_FRAMES


@pytest.mark.parametrize("key", ["masks", "scores", "logits", "click_mask", "click_logit",
                                 "click_painted"])
def test_outputs_bit_equal_with_the_profiler_on_and_off(runs, key):
    on, off = runs["on"][key], runs["off"][key]
    assert on.shape == off.shape and on.dtype == off.dtype
    np.testing.assert_array_equal(on, off)
