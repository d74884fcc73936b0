"""The port's one staleness rule for what it derives from parameters
(`models/layers.param_stamp`, `stamp_holds`) and its two consumers: the
layers' cache (`layers._derived`) and XMem's key-encoder CUDA graphs
(`models/xmem/network._KeyGraphs`).

XMem keeps fp32 parameters and runs bf16 activations, so every convolution
casts its weight and every BN builds its scale and shift from the running
statistics. Under `torch.no_grad` those tensors are built once and kept on
the module, one entry per activation dtype and device. Held here: outputs
bit-equal to the call-time expressions (copied below as they stood before
the cache), one table of parameter changes run against both consumers (each
change rebuilds both or keeps both), a second dtype kept beside the first,
no caching with grad enabled, only hits once warm, and the op count of a
warmed `core.step`. The three XMem rollouts are made once per module.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from vosesam_tpu_torch import config as C
from vosesam_tpu_torch.inference import core
from vosesam_tpu_torch.models import layers
from vosesam_tpu_torch.models.xmem import network as xn
from vosesam_tpu_torch.models.xmem.network import XMem

H, W = 48, 64
O = 2
STEPS = 6


# ------------------------------------------------ call-time expressions


def _calltime_conv2d(x, conv):
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, conv.groups)


def _calltime_linear(x, lin):
    w = lin.weight.to(x.dtype)
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, w, b)


def _calltime_conv_transpose2d(x, conv):
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv_transpose2d(x, w, b, conv.stride, conv.padding)


def _calltime_layer_norm(x, ln, eps=1e-6):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * ln.weight.float() + ln.bias.float()).to(x.dtype)


def _calltime_batch_norm(x, bn):
    inv = torch.rsqrt(bn.running_var.float() + bn.eps)
    w = bn.weight.float()
    scale = (w * inv).to(x.dtype)
    shift = (bn.bias.float() - bn.running_mean.float() * w * inv).to(x.dtype)
    return x * scale[:, None, None] + shift[:, None, None]


def _use_calltime(mp: pytest.MonkeyPatch) -> None:
    mp.setattr(layers, "conv2d", _calltime_conv2d)
    mp.setattr(layers, "linear", _calltime_linear)
    mp.setattr(layers, "batch_norm", _calltime_batch_norm)


@pytest.fixture
def calltime(monkeypatch):
    """Route the layer classes through the call-time expressions."""
    return lambda: _use_calltime(monkeypatch)


@pytest.fixture(autouse=True)
def _counts():
    layers.reset_param_cache_counts()
    xn.reset_key_graph_counts()
    yield
    layers.reset_param_cache_counts()
    xn.reset_key_graph_counts()


# ------------------------------------------------------------ fixtures


def _randomize_bn(module: nn.Module, rng: np.random.Generator) -> None:
    """BN statistics and affine away from the identity, so scale and shift
    carry real values."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(
                    rng.uniform(-0.2, 0.2, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))


def _cfg() -> C.FrameworkConfig:
    return dataclasses.replace(C.small_test_config(), xmem=C.XMemConfig(max_objects=O),
                               dtype="bfloat16")


def _net() -> XMem:
    torch.manual_seed(0)
    net = XMem(_cfg().xmem).eval()
    _randomize_bn(net, np.random.default_rng(1))
    return net


def _video():
    r = np.random.default_rng(2)
    frames = [torch.from_numpy(r.integers(0, 256, (H, W, 3), dtype=np.uint8))
              for _ in range(STEPS + 1)]
    mask = torch.zeros((O, H, W), dtype=torch.float32)
    mask[0, 8:30, 10:40] = 1.0
    mask[1, 28:44, 36:60] = 1.0
    return frames, mask, torch.ones(O, dtype=torch.bool)


def _rollout(net, cfg, video, steps=STEPS):
    """step_with_mask on frame 0, then `steps` propagated frames (memory
    frames every `mem_every` = 2)."""
    frames, mask, valid = video
    state = core.init_tracker_state(cfg, (H, W), device="cpu")
    state, prob, logits = core.step_with_mask(net, state, frames[0], mask, valid, cfg)
    out = [(prob, logits)]
    for t in range(1, steps + 1):
        state, prob, logits = core.step(net, state, frames[t], cfg)
        out.append((prob, logits))
    return state, out


@pytest.fixture(scope="module")
def rollouts():
    """One net rolled out twice (`first` fills the cache, `warm` reads it),
    and a copy made before either rolled out through the call-time
    expressions (`ref`). Each net is kept with its state for one more step,
    with the counts read after each rollout."""
    cfg, video = _cfg(), _video()
    layers.reset_param_cache_counts()
    net = _net()
    ref_net = copy.deepcopy(net)
    _, first = _rollout(net, cfg, video)
    first_counts = dict(layers.PARAM_CACHE_COUNTS)
    state, warm = _rollout(net, cfg, video)
    warm_counts = dict(layers.PARAM_CACHE_COUNTS)
    with pytest.MonkeyPatch.context() as mp:
        _use_calltime(mp)
        layers.reset_param_cache_counts()
        ref_state, ref = _rollout(ref_net, cfg, video)
        ref_counts = dict(layers.PARAM_CACHE_COUNTS)
    return types.SimpleNamespace(
        cfg=cfg, video=video, net=net, state=state, first=first, warm=warm,
        first_counts=first_counts, warm_counts=warm_counts, ref_net=ref_net,
        ref_state=ref_state, ref=ref, ref_counts=ref_counts)


# ------------------------------------------------------------ (a) bits


def test_rollout_bit_equal_to_calltime_expressions(rollouts):
    r = rollouts
    assert r.first_counts["miss"] > 0                 # the first rollout fills the cache
    assert r.warm_counts["hit"] > 0                   # the second reads it
    assert r.ref_counts == {"hit": 0, "miss": 0, "bypass": 0}

    for (p1, l1), (p2, l2), (pr, lr) in zip(r.first, r.warm, r.ref):
        assert torch.equal(p1, pr) and torch.equal(l1, lr)
        assert torch.equal(p2, pr) and torch.equal(l2, lr)


def _helper_case(name, param_dtype):
    """(helper, call-time twin, module, input) at a small shape."""
    torch.manual_seed(8)
    x = torch.randn(2, 6, 5, 7).to(torch.bfloat16)
    if name == "conv2d":
        mod, twin = nn.Conv2d(6, 4, 3, padding=1), _calltime_conv2d
    elif name == "linear":
        mod, twin = nn.Linear(7, 3), _calltime_linear
    elif name == "batch_norm":
        mod, twin = nn.BatchNorm2d(6), _calltime_batch_norm
        _randomize_bn(mod, np.random.default_rng(9))
    elif name == "conv_transpose2d":
        mod, twin = nn.ConvTranspose2d(6, 4, 2, stride=2), _calltime_conv_transpose2d
    else:
        mod, twin = nn.LayerNorm(7), _calltime_layer_norm
        with torch.no_grad():
            mod.weight.uniform_(0.5, 1.5)
            mod.bias.uniform_(-0.5, 0.5)
    return getattr(layers, name), twin, mod.to(param_dtype), x


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["conv2d", "linear", "batch_norm", "conv_transpose2d",
                                  "layer_norm"])
def test_each_helper_bit_equal_and_kept(name, param_dtype):
    """Every helper, with fp32 (XMem) and bf16 (SAM-HQ) parameters: a build,
    then a hit, both bit-equal to the call-time expressions."""
    helper, twin, mod, x = _helper_case(name, param_dtype)
    with torch.no_grad():
        want = twin(x, mod)
        first = helper(x, mod)
        again = helper(x, mod)
    assert layers.PARAM_CACHE_COUNTS == {"hit": 1, "miss": 1, "bypass": 0}
    assert torch.equal(first, want) and torch.equal(again, want)


# ---------------------------------------------------- (b) the one rule


class _Trunk(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.conv = layers.Conv2d(4, 6, 3, padding=1)
        self.bn = layers.BatchNorm2d(6)


class _Block(nn.Module):
    """conv -> BN -> relu -> mean -> linear, under the names of XMem's key
    path (`key_encoder`, `key_proj`), whose tensors the key-encoder graphs
    stamp (`network._key_sources`)."""

    def __init__(self) -> None:
        super().__init__()
        self.key_encoder = _Trunk()
        self.key_proj = layers.Linear(6, 3)

    def forward(self, x):
        e = self.key_encoder
        y = torch.relu(e.bn(e.conv(x)))
        return self.key_proj(y.mean(dim=(-2, -1)))


def _block() -> _Block:
    torch.manual_seed(3)
    b = _Block().eval()
    _randomize_bn(b, np.random.default_rng(4))
    return b


def _x(dtype=torch.bfloat16):
    return torch.randn(2, 4, 5, 7, generator=torch.Generator().manual_seed(5)).to(dtype)


def _load_state_dict(b):
    torch.manual_seed(6)
    other = _Block()
    _randomize_bn(other, np.random.default_rng(7))
    b.load_state_dict(other.state_dict())


def _data_reassign(b):
    w = b.key_encoder.conv.weight
    w.data = w.data * 0.5


def _replace_parameter(b):
    bn = b.key_encoder.bn
    bn.bias = nn.Parameter(bn.bias + 0.25)


def _rewrap_parameter(b):
    """A new Parameter over the same storage, updated in place until its
    version counter reads what the old one's did: only identity tells."""
    bn = b.key_encoder.bn
    old = bn.bias
    new = nn.Parameter(old.data)
    bn.bias = new
    new.add_(0.25)
    while new._version < old._version:
        new.add_(0.0)


def _replace_submodule(b):
    b.key_encoder.bn = copy.deepcopy(b.key_encoder.bn)


# name -> (change, rebuilds, changes the output); float64 copies of float32
# values and a deep copy cast alike, so those two change no output
MUTATIONS = {
    "nothing": (lambda b: None, False, False),
    "to_same_dtype": (lambda b: b.to(torch.float32), False, False),
    "load_state_dict": (_load_state_dict, True, True),
    "copy_conv_weight": (lambda b: b.key_encoder.conv.weight.mul_(1.5), True, True),
    "copy_conv_bias": (lambda b: b.key_encoder.conv.bias.add_(0.5), True, True),
    "copy_bn_weight": (lambda b: b.key_encoder.bn.weight.neg_(), True, True),
    "copy_bn_running_var": (lambda b: b.key_encoder.bn.running_var.mul_(3.0), True, True),
    "data_reassignment": (_data_reassign, True, True),
    "rewrap_parameter": (_rewrap_parameter, True, True),
    "replace_parameter": (_replace_parameter, True, True),
    "replace_submodule": (_replace_submodule, True, False),
    "module_to": (lambda b: b.to(torch.float64), True, False),
}


@pytest.mark.parametrize("consumer", ["derived", "key_graphs"])
@pytest.mark.parametrize("name", list(MUTATIONS))
def test_change_of_parameters_rebuilds(name, consumer, calltime):
    """Each change against each consumer of the rule: the layers' entries
    rebuild (to the call-time outputs) or stay; the graphs all go or stay."""
    mutate, rebuilds, changes_output = MUTATIONS[name]
    b = _block()
    if consumer == "derived":
        x = _x()
        with torch.no_grad():
            before = b(x)
            b(x)
            assert layers.PARAM_CACHE_COUNTS == {"hit": 3, "miss": 3, "bypass": 0}
            mutate(b)
            layers.reset_param_cache_counts()
            after = b(x)
        assert (layers.PARAM_CACHE_COUNTS["miss"] >= 1) is rebuilds
        assert torch.equal(after, before) is not changes_output
        calltime()
        with torch.no_grad():
            assert torch.equal(after, b(x))
        return
    graphs, made = xn._KeyGraphs(), []
    capture = lambda: made.append(object()) or made[-1]   # noqa: E731
    first = graphs.lookup(("a",), xn._key_sources(b), capture)
    graphs.lookup(("b",), xn._key_sources(b), capture)
    with torch.no_grad():
        mutate(b)
    again = graphs.lookup(("a",), xn._key_sources(b), capture)
    if rebuilds:
        assert again is not first and list(graphs) == [("a",)]
        assert xn.KEY_GRAPH_COUNTS == {"replay": 0, "capture": 3, "eager": 0}
    else:
        assert again is first and list(graphs) == [("b",), ("a",)]
        assert xn.KEY_GRAPH_COUNTS == {"replay": 1, "capture": 2, "eager": 0}


def test_second_dtype_rebuilds(calltime):
    """A second dtype builds its own entries and the first dtype's stay; a
    parameter change then drops the entries it makes stale."""
    b = _block()
    with torch.no_grad():
        b(_x(torch.bfloat16))
        layers.reset_param_cache_counts()
        out32 = b(_x(torch.float32))
        assert layers.PARAM_CACHE_COUNTS == {"hit": 0, "miss": 3, "bypass": 0}
        assert out32.dtype == torch.float32
        b(_x(torch.bfloat16))
        assert layers.PARAM_CACHE_COUNTS == {"hit": 3, "miss": 3, "bypass": 0}
        b.key_proj.weight.mul_(2.0)
        out32 = b(_x(torch.float32))
        assert list(b.key_proj.__dict__["_derived_params"]) == [(torch.float32,
                                                                 torch.device("cpu"))]
        assert len(b.key_encoder.conv.__dict__["_derived_params"]) == 2
        calltime()
        assert torch.equal(out32, b(_x(torch.float32)))


# ----------------------------------------------------------- (c) grad mode


def test_grad_mode_bypasses_the_cache(calltime):
    b, x = _block(), _x()
    mods = (b.key_encoder.conv, b.key_encoder.bn, b.key_proj)
    with torch.no_grad():
        b(x)                                          # an entry for each layer
        for mod in mods:                              # poison it: a read would show
            for _, out in mod.__dict__["_derived_params"].values():
                for t in out:
                    if t is not None:
                        t.zero_()
    entries = [m.__dict__["_derived_params"] for m in mods]
    ref = _block()                                    # same parameters, no entries
    layers.reset_param_cache_counts()

    out = b(x)
    out.float().square().sum().backward()
    assert layers.PARAM_CACHE_COUNTS == {"hit": 0, "miss": 0, "bypass": 3}
    assert all(m.__dict__["_derived_params"] is e for m, e in zip(mods, entries))
    fresh = _block()
    fresh(x)
    assert not any("_derived_params" in m.__dict__ for m in fresh.modules())

    calltime()
    out_ref = ref(x)
    out_ref.float().square().sum().backward()
    assert torch.equal(out, out_ref)
    for got, want in ((b.key_encoder.conv.weight, ref.key_encoder.conv.weight),
                      (b.key_encoder.bn.weight, ref.key_encoder.bn.weight),
                      (b.key_encoder.bn.bias, ref.key_encoder.bn.bias)):
        assert got.grad is not None
        assert torch.equal(got.grad, want.grad)


# ----------------------------------------------------------- (d) engagement


def test_warmed_step_is_all_hits(rollouts):
    r = rollouts
    layers.reset_param_cache_counts()
    core.step(r.net, copy.deepcopy(r.state), r.video[0][1], r.cfg)
    counts = layers.PARAM_CACHE_COUNTS
    assert counts["miss"] == 0 and counts["bypass"] == 0
    assert counts["hit"] > 0
    assert counts["hit"] / (counts["hit"] + counts["miss"] + counts["bypass"]) == 1.0


# ------------------------------------------------------------- (e) op count

# aten ops that launch no work: views, aliases, allocation, metadata
_NO_WORK = {
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::view",
    "aten::as_strided", "aten::reshape", "aten::_reshape_alias", "aten::unsqueeze",
    "aten::squeeze", "aten::expand", "aten::permute", "aten::transpose", "aten::t",
    "aten::slice", "aten::select", "aten::detach", "aten::alias", "aten::resolve_conj",
    "aten::resolve_neg", "aten::_unsafe_view", "aten::lift_fresh", "aten::unbind",
    "aten::split", "aten::chunk", "aten::narrow", "aten::item", "aten::_local_scalar_dense",
    "aten::is_nonzero", "aten::contiguous", "aten::to", "aten::result_type",
    "aten::set_", "aten::resize_", "aten::view_as", "aten::expand_as", "aten::flatten",
    "aten::numpy_T", "aten::size", "aten::stride", "aten::dim", "aten::as_strided_",
    "aten::detach_", "aten::movedim",
}


def _compute_ops(fn):
    """Names of the leaf aten ops that `fn` runs, views and allocations
    left out (each is one kernel launch on the card). The autograd
    profiler's own event tree, without Kineto, whose first start costs
    seconds on the CPU; the events are the same."""
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        fn()
    names = []
    for ev in prof.function_events:
        if not ev.name.startswith("aten::") or ev.name in _NO_WORK:
            continue
        if any(c.name.startswith("aten::") and c.name not in _NO_WORK
               for c in ev.cpu_children):
            continue                                 # counted at its children
        names.append(ev.name)
    return names


def test_warmed_step_issues_fewer_ops(rollouts, calltime):
    r = rollouts
    frame = r.video[0][3]
    cached = _compute_ops(lambda: core.step(r.net, copy.deepcopy(r.state), frame, r.cfg))
    calltime()
    today = _compute_ops(lambda: core.step(r.ref_net, copy.deepcopy(r.ref_state), frame,
                                           r.cfg))
    assert "aten::rsqrt" in today
    assert "aten::rsqrt" not in cached
    assert len(cached) <= 0.55 * len(today), (len(cached), len(today))
