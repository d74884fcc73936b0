"""The key encoder's CUDA graph (`models/xmem/network.py:encode_key`).

On the CPU, at 32x32 frames:
  - off the card, on the meta device and with grad enabled `encode_key`
    runs eagerly and counts `eager`, with outputs bit-equal to the eager
    expressions; the predicate that picks the graph refuses grad mode and a
    capture under way;
  - the signature tells apart shape, dtype, strides, device and each cuDNN
    flag; at most `KEY_GRAPH_LIMIT` graphs are kept, the least recently used
    going first; a copied or pickled net keeps none; a forward hook keeps
    the eager path.

When a parameter change drops the graphs is the layer library's one rule
(`layers.stamp_holds`); `tests/test_torch_param_cache.py` runs its table of
changes against the graphs and against the layers' own cache.

On the card (marker `cuda`; `python -m pytest tests/test_torch_key_graph.py
-m cuda --noconftest`, since the suite's conftest imports JAX), at 480x854
bf16 frames: replays bit-equal to the eager path with the same layouts, one
capture per signature and replays after it, outputs that no later call
writes, a recapture after `load_state_dict`, a graph per frame shape and per
cuDNN TF32 flag, and the benchmark check's forward hook on `decoder.pred`
still firing in `core.step`.
"""

import copy
import os
import pickle
import sys
import threading
import types

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import FrameworkConfig, XMemConfig
from vosesam_tpu_torch.inference import core
from vosesam_tpu_torch.models.xmem import network as xn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eager(net, frame):
    """`encode_key`'s outputs by the expressions it ran before the graph."""
    f4, f8, f16 = net.key_encoder.features(xn._chw(frame)[None])
    key, shrinkage, selection = net.key_proj(f16)
    return (xn._hwc(key[0]), xn._hwc(shrinkage[0]), xn._hwc(selection[0]),
            xn._hwc(f16[0]), xn._hwc(f8[0]), xn._hwc(f4[0]))


def _flat(out):
    return (*out[:3], out[3].f16, out[3].f8, out[3].f4)


def _assert_same(got, want):
    for g, w in zip(_flat(got), want):
        assert g.shape == w.shape and g.stride() == w.stride() and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    return xn.XMem(XMemConfig()).eval()


@pytest.fixture
def counts():
    xn.reset_key_graph_counts()
    yield xn.KEY_GRAPH_COUNTS
    xn.reset_key_graph_counts()


# ------------------------------------------------------------------ the CPU

@pytest.mark.parametrize("where", ["cpu", "cpu_grad", "meta"])
def test_off_the_card_runs_eagerly(net, counts, monkeypatch, where):
    monkeypatch.setattr(xn, "_replay_key", None)        # never reached
    if where == "meta":
        # the path and its count, without the meta convolutions' first-use cost
        ran = []
        monkeypatch.setattr(xn, "_key_trunk", lambda m, x: ran.append(x.device) or (
            torch.empty(1, 8, 2, 2, device=x.device),) * 6)
        xn.encode_key(net, torch.empty(32, 32, 3, device="meta"))
        assert ran == [torch.device("meta")]
    else:
        frame = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (32, 32, 3)).astype(np.float32))
        with torch.set_grad_enabled(where == "cpu_grad"):
            _assert_same(xn.encode_key(net, frame), _eager(net, frame))
    assert counts == {"replay": 0, "capture": 0, "eager": 1}
    assert "_key_graphs" not in net.__dict__


@pytest.mark.parametrize("grad, capturing, cuda, expect", [
    (False, False, True, True),
    (True, False, True, False),
    (False, True, True, False),
    (False, False, False, False),
])
def test_the_graph_needs_the_card_no_grad_and_no_capture(monkeypatch, grad, capturing,
                                                         cuda, expect):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    with torch.set_grad_enabled(grad):
        assert xn._graphable(types.SimpleNamespace(is_cuda=cuda)) is expect


@pytest.mark.parametrize("change", [
    "shape", "dtype", "strides", "device",
    "cudnn.enabled", "cudnn.allow_tf32", "cudnn.deterministic", "cudnn.benchmark",
])
def test_the_signature_tells_apart(change):
    base = torch.zeros(32, 32, 3)
    sig = xn._key_signature(base)
    assert xn._key_signature(torch.ones(32, 32, 3)) == sig
    if change.startswith("cudnn."):
        flag = change.split(".")[1]
        with torch.backends.cudnn.flags(**{
                f: (not getattr(torch.backends.cudnn, f)) if f == flag
                else getattr(torch.backends.cudnn, f)
                for f in ("enabled", "benchmark", "deterministic", "allow_tf32")}):
            other = xn._key_signature(base)
    else:
        other = xn._key_signature({
            "shape": torch.zeros(32, 48, 3),
            "dtype": torch.zeros(32, 32, 3, dtype=torch.bfloat16),
            "strides": torch.zeros(3, 32, 32).permute(1, 2, 0),
            "device": torch.zeros(32, 32, 3, device="meta"),
        }[change])
    assert other != sig


def test_graphs_are_bounded_least_recently_used_first(net, counts):
    sources = xn._key_sources(net)
    graphs = xn._KeyGraphs()
    for i in range(xn.KEY_GRAPH_LIMIT):
        graphs.lookup((i,), sources, object)
    graphs.lookup((0,), sources, object)
    graphs.lookup(("new",), sources, object)
    assert list(graphs) == [(i,) for i in range(2, xn.KEY_GRAPH_LIMIT)] + [(0,), ("new",)]
    assert counts == {"replay": 1, "capture": xn.KEY_GRAPH_LIMIT + 1, "eager": 0}


def test_a_copied_or_pickled_net_starts_without_graphs():
    graphs = xn._KeyGraphs()
    graphs[("a",)] = threading.Lock()           # neither copies nor pickles
    model = torch.nn.Module()
    model.__dict__["_key_graphs"] = graphs
    assert len(copy.deepcopy(model).__dict__["_key_graphs"]) == 0
    assert len(pickle.loads(pickle.dumps(model)).__dict__["_key_graphs"]) == 0


@pytest.mark.parametrize("where", ["module", "global"])
def test_a_forward_hook_keeps_the_eager_path(net, where):
    assert xn._key_sources(net) is not None
    if where == "module":
        handle = net.key_encoder.layer2[1].conv2.register_forward_hook(lambda *a: None)
    else:
        handle = torch.nn.modules.module.register_module_forward_pre_hook(lambda *a: None)
    try:
        assert xn._key_sources(net) is None
    finally:
        handle.remove()
    assert xn._key_sources(net) is not None


# ----------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_net(card):
    torch.manual_seed(1)
    return xn.XMem(XMemConfig()).eval().to(card)


def _frame(card, seed, hw=(480, 854), dtype="bfloat16"):
    """A padded, normalized frame as `core._prepare` makes it."""
    rgb = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (*hw, 3), dtype=np.uint8)).to(card)
    return core._prepare(rgb, FrameworkConfig(dtype=dtype))[0]


@pytest.mark.cuda
def test_replays_are_bit_equal_to_the_eager_path(card, card_net, counts):
    card_net.__dict__.pop("_key_graphs", None)
    with torch.no_grad():
        for i in range(8):
            frame = _frame(card, i)
            got = xn.encode_key(card_net, frame)
            _assert_same(got, _eager(card_net, frame))
    assert counts == {"replay": 7, "capture": 1, "eager": 0}


@pytest.mark.cuda
def test_no_later_call_writes_an_earlier_result(card, card_net, counts):
    with torch.no_grad():
        first = _flat(xn.encode_key(card_net, _frame(card, 10)))
        kept = [t.clone() for t in first]
        second = _flat(xn.encode_key(card_net, _frame(card, 11)))
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not any(torch.equal(a, b) for a, b in zip(first, second))
    assert counts["eager"] == 0 and counts["replay"] >= 1


@pytest.mark.cuda
def test_new_weights_are_captured_anew(card, counts):
    torch.manual_seed(2)
    model = xn.XMem(XMemConfig()).eval().to(card)
    frame = _frame(card, 20)
    with torch.no_grad():
        before = xn.encode_key(model, frame)
        xn.encode_key(model, frame)
        torch.manual_seed(3)
        model.load_state_dict(xn.XMem(XMemConfig()).state_dict())
        after = xn.encode_key(model, frame)
        _assert_same(after, _eager(model, frame))
        assert not torch.equal(after[0], before[0])
        xn.encode_key(model, frame)
    assert counts == {"replay": 2, "capture": 2, "eager": 0}


@pytest.mark.cuda
def test_each_frame_shape_and_tf32_flag_gets_its_own_graph(card, card_net, counts):
    card_net.__dict__.pop("_key_graphs", None)
    with torch.no_grad():
        for _ in range(2):
            for hw in ((480, 854), (360, 640)):
                frame = _frame(card, hw[0], hw)
                _assert_same(xn.encode_key(card_net, frame), _eager(card_net, frame))
            frame = _frame(card, 30, (240, 432), dtype="float32")
            for tf32 in (True, False):
                with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                deterministic=False, allow_tf32=tf32):
                    _assert_same(xn.encode_key(card_net, frame), _eager(card_net, frame))
    assert counts == {"replay": 4, "capture": 4, "eager": 0}
    assert len(card_net.__dict__["_key_graphs"]) == 4


@pytest.mark.cuda
def test_the_checks_hook_on_the_decoder_still_fires(card, card_net, counts):
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        from harness.capture import module_outputs, xmem_modules
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmark"))
    cfg = FrameworkConfig(xmem=XMemConfig(max_objects=2))
    state = core.init_tracker_state(cfg, (480, 854), card)
    rgb = [torch.from_numpy(np.random.default_rng(40 + i).integers(
        0, 256, (480, 854, 3), dtype=np.uint8)).to(card) for i in range(3)]
    mask = torch.zeros(2, 480, 854, device=card)
    mask[0, 100:200, 100:300] = 1
    mask[1, 300:400, 500:700] = 1
    valid = torch.tensor([True, True], device=card)
    rec = {}
    with module_outputs(xmem_modules(card_net), rec):
        state, _, _ = core.step_with_mask(card_net, state, rgb[0], mask, valid, cfg)
        for f in rgb[1:]:
            state, _, _ = core.step(card_net, state, f, cfg)
    assert len(rec["pred"]) == 2 and len(rec["value_fuser"]) >= 1
    assert counts["eager"] == 0 and counts["replay"] + counts["capture"] == 3


@pytest.mark.cuda
def test_a_hook_on_the_trunk_fires_on_the_card(card, card_net, counts):
    fired = []
    handle = card_net.key_encoder.layer3[0].conv1.register_forward_hook(
        lambda *a: fired.append(1))
    try:
        with torch.no_grad():
            frame = _frame(card, 50)
            _assert_same(xn.encode_key(card_net, frame), _eager(card_net, frame))
    finally:
        handle.remove()
    assert counts["eager"] == 1 and len(fired) == 2
