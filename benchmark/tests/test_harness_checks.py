"""The run's last line, and the check that decides `correct`, at a size a
test run can hold (`tiny.py`, on the CPU, the program in float32): a sound
run is correct; the control (the reference in float8 in the program's
place) fails at least one number; and each fault that a cell can have,
planted under the timed path, turns `correct` false. These drive
`cli.run_cell`, past the harness's look for a card."""

import json
import time

import numpy as np
import pytest
import torch

import tiny
from harness import cli, registry

SEED = 2**35 + 77


def run(workload, trace=False, seconds=0.0):
    bench, wl, cfg, spec = tiny.cell(workload)
    torch.manual_seed(0)
    return cli.run_cell(bench, wl, cfg, spec, SEED, seconds, trace, torch.device("cpu"),
                        time.perf_counter())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(trace):
    out = run("xmem.long_video", trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in out["device"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    for c in out["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("workload", ["refined.davis", "xmem.long_video", "click.samhq"])
def test_control_fails_a_number(workload):
    import control

    bench, wl, cfg, spec = tiny.cell(workload)
    r = control.readings(workload, SEED, torch.device("cpu"), cfg, spec)
    lim = registry.limits(workload)["numbers"]
    assert all(r["program"][k] <= v["limit"] for k, v in lim.items()), r["program"]
    assert any(r["control"][k] > v["limit"] for k, v in lim.items()), r["control"]


P = "vosesam_tpu_torch."


def _state_unchanged(monkeypatch):
    from vosesam_tpu_torch.inference import core

    monkeypatch.setattr(core, "_maybe_memorize", lambda net, cfg, state, *a, **k: state)


def _half_batch(monkeypatch):
    from vosesam_tpu_torch.inference import tracker

    orig = tracker.track_chunk

    def half(net, sam, state, frames, cfg):
        k = frames.shape[0] // 2
        state, idx, scores, used = orig(net, sam, state, frames[:k], cfg)
        rep = lambda t: None if t is None else torch.cat([t, t[-1:].expand(  # noqa: E731
            frames.shape[0] - k, *t.shape[1:])])
        return state, rep(idx), rep(scores), rep(used)

    monkeypatch.setattr(tracker, "track_chunk", half)


def _answer_altered(monkeypatch):
    from vosesam_tpu_torch.inference import tracker

    orig = tracker.track_chunk

    def altered(net, sam, state, frames, cfg):
        state, idx, scores, used = orig(net, sam, state, frames, cfg)
        idx = idx.clone()
        idx[-1] = torch.where(idx[-1] > 0, 0, 1)          # the last frame's labels swapped
        return state, idx, scores, used

    monkeypatch.setattr(tracker, "track_chunk", altered)


def _click_altered(monkeypatch):
    from vosesam_tpu_torch.pipeline import interact

    orig = interact.click_full

    def altered(*a, **k):
        mask, low_res, painted = orig(*a, **k)
        return ~mask, low_res, painted

    monkeypatch.setattr(interact, "click_full", altered)


def _click_stale_embedding(monkeypatch):
    from vosesam_tpu_torch.pipeline import interact

    orig = interact.SamController.set_image

    def stale(self, image):
        if getattr(self, "_first", None) is None:
            orig(self, image)
            self._first = self.emb
        self.emb = self._first

    monkeypatch.setattr(interact.SamController, "set_image", stale)


def _aggregate_altered(monkeypatch):
    from vosesam_tpu_torch.models.xmem import network

    orig = network.soft_aggregate

    def altered(prob, *a, **k):
        return orig(torch.sigmoid(prob), *a, **k)        # the sigmoid taken twice

    monkeypatch.setattr(network, "soft_aggregate", altered)


FAULTS = [
    ("xmem.long_video", _state_unchanged), ("xmem.long_video", _half_batch),
    ("xmem.long_video", _answer_altered),
    ("refined.davis", _state_unchanged), ("refined.davis", _half_batch),
    ("refined.davis", _answer_altered),
    ("xmem.long_video", _aggregate_altered), ("refined.davis", _aggregate_altered),
    ("click.samhq", _click_altered), ("click.samhq", _click_stale_embedding),
]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run(workload)
    assert out is not None and out["correct"] is False, out["check"]


def test_a_plain_fallback_on_the_card_is_not_correct(monkeypatch):
    """On the card a kernel's plain version must not run in the window; on
    the CPU the plain versions are the path, so this run stands in by
    treating the CPU as the card."""
    from harness import cli as c

    monkeypatch.setattr(c, "fallbacks_allowed", lambda device: False)
    out = run("xmem.long_video")
    assert out["correct"] is False and out["check"]["plain_fallbacks"]["value"] > 0
