"""The layer library's derived-parameter cache (`models/layers._derived`).

XMem keeps fp32 parameters and runs bf16 activations, so every convolution
casts its weight and every BN builds its scale and shift from the running
statistics. Under `torch.no_grad` those tensors are built once and kept on
the module. Held here: outputs bit-equal to the call-time expressions
(copied below as they stood before the cache), a rebuild after every kind
of parameter change, no caching with grad enabled, only hits once warm, and
the op count of a warmed `core.step`.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from vosesam_tpu_torch import config as C
from vosesam_tpu_torch.inference import core
from vosesam_tpu_torch.models import layers
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


@pytest.fixture
def calltime(monkeypatch):
    """Route the layer classes through the call-time expressions."""
    def use():
        monkeypatch.setattr(layers, "conv2d", _calltime_conv2d)
        monkeypatch.setattr(layers, "linear", _calltime_linear)
        monkeypatch.setattr(layers, "batch_norm", _calltime_batch_norm)
    return use


@pytest.fixture(autouse=True)
def _counts():
    layers.reset_param_cache_counts()
    yield
    layers.reset_param_cache_counts()


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


# ------------------------------------------------------------ (a) bits


def test_rollout_bit_equal_to_calltime_expressions(calltime):
    cfg, video = _cfg(), _video()
    net = _net()
    _, first = _rollout(net, cfg, video)            # fills the cache
    assert layers.PARAM_CACHE_COUNTS["miss"] > 0
    _, warm = _rollout(net, cfg, video)             # reads it
    assert layers.PARAM_CACHE_COUNTS["hit"] > 0

    calltime()
    layers.reset_param_cache_counts()
    _, ref = _rollout(_net(), cfg, video)
    assert layers.PARAM_CACHE_COUNTS == {"hit": 0, "miss": 0, "bypass": 0}

    for (p1, l1), (p2, l2), (pr, lr) in zip(first, warm, ref):
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


# ------------------------------------------------------- (b) staleness


class _Block(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.conv = layers.Conv2d(4, 6, 3, padding=1)
        self.bn = layers.BatchNorm2d(6)
        self.fc = layers.Linear(6, 3)

    def forward(self, x):
        y = torch.relu(self.bn(self.conv(x)))
        return self.fc(y.mean(dim=(-2, -1)))


def _block() -> _Block:
    torch.manual_seed(3)
    b = _Block().eval()
    _randomize_bn(b, np.random.default_rng(4))
    return b


def _x(dtype=torch.bfloat16):
    return torch.randn(2, 4, 5, 7, generator=torch.Generator().manual_seed(5)).to(dtype)


def _copy_conv_weight(b):
    b.conv.weight.copy_(b.conv.weight * 1.5)


def _copy_running_var(b):
    b.bn.running_var.copy_(b.bn.running_var * 3.0)


def _copy_bn_weight(b):
    b.bn.weight.copy_(-b.bn.weight)


def _load_state_dict(b):
    torch.manual_seed(6)
    other = _Block()
    _randomize_bn(other, np.random.default_rng(7))
    b.load_state_dict(other.state_dict())


def _data_reassign(b):
    b.conv.weight.data = b.conv.weight.data * 0.5


def _replace_parameter(b):
    b.bn.bias = nn.Parameter(b.bn.bias + 0.25)


def _rewrap_parameter(b):
    """A new Parameter over the same storage, updated in place until its
    version counter reads what the old one's did: only identity tells."""
    old = b.bn.bias
    new = nn.Parameter(old.data)
    b.bn.bias = new
    new.add_(0.25)
    while new._version < old._version:
        new.add_(0.0)


def _module_to(b):
    b.to(torch.float64)


MUTATIONS = {
    "copy_conv_weight": _copy_conv_weight,
    "copy_bn_running_var": _copy_running_var,
    "copy_bn_weight": _copy_bn_weight,
    "load_state_dict": _load_state_dict,
    "data_reassignment": _data_reassign,
    "replace_parameter": _replace_parameter,
    "rewrap_parameter": _rewrap_parameter,
    "module_to": _module_to,
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_change_of_parameters_rebuilds(name, calltime):
    b, x = _block(), _x()
    with torch.no_grad():
        before = b(x)
        b(x)
        assert layers.PARAM_CACHE_COUNTS["miss"] == 3
        assert layers.PARAM_CACHE_COUNTS["hit"] == 3
        MUTATIONS[name](b)
        layers.reset_param_cache_counts()
        after = b(x)
    assert layers.PARAM_CACHE_COUNTS["miss"] >= 1
    if name != "module_to":          # float64 copies of float32 values cast alike
        assert not torch.equal(after, before)

    calltime()
    with torch.no_grad():
        assert torch.equal(after, b(x))


def test_second_dtype_rebuilds(calltime):
    b = _block()
    with torch.no_grad():
        b(_x(torch.bfloat16))
        layers.reset_param_cache_counts()
        out32 = b(_x(torch.float32))
        assert layers.PARAM_CACHE_COUNTS == {"hit": 0, "miss": 3, "bypass": 0}
        assert out32.dtype == torch.float32
        calltime()
        assert torch.equal(out32, b(_x(torch.float32)))


# ----------------------------------------------------------- (c) grad mode


def test_grad_mode_bypasses_the_cache(calltime):
    b, x = _block(), _x()
    with torch.no_grad():
        b(x)                                          # an entry for each layer
        for mod in (b.conv, b.bn, b.fc):              # poison it: a read would show
            for t in mod.__dict__["_derived_params"][3]:
                if t is not None:
                    t.zero_()
    entries = [m.__dict__["_derived_params"] for m in (b.conv, b.bn, b.fc)]
    ref = _block()                                    # same parameters, no entries
    layers.reset_param_cache_counts()

    out = b(x)
    out.float().square().sum().backward()
    assert layers.PARAM_CACHE_COUNTS == {"hit": 0, "miss": 0, "bypass": 3}
    assert all(m.__dict__["_derived_params"] is e for m, e in zip((b.conv, b.bn, b.fc), entries))
    fresh = _block()
    fresh(x)
    assert not any("_derived_params" in m.__dict__ for m in fresh.modules())

    calltime()
    out_ref = ref(x)
    out_ref.float().square().sum().backward()
    assert torch.equal(out, out_ref)
    for got, want in ((b.conv.weight, ref.conv.weight), (b.bn.weight, ref.bn.weight),
                      (b.bn.bias, ref.bn.bias)):
        assert got.grad is not None
        assert torch.equal(got.grad, want.grad)


# ----------------------------------------------------------- (d) engagement


def test_warmed_step_is_all_hits():
    cfg, video = _cfg(), _video()
    net = _net()
    state, _ = _rollout(net, cfg, video)              # warm-up: every module has run
    layers.reset_param_cache_counts()
    core.step(net, state, video[0][1], cfg)
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
    left out (each is one kernel launch on the card)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = []
    for ev in prof.events():
        if not ev.name.startswith("aten::") or ev.name in _NO_WORK:
            continue
        if any(c.name.startswith("aten::") and c.name not in _NO_WORK
               for c in ev.cpu_children):
            continue                                 # counted at its children
        names.append(ev.name)
    return names


def test_warmed_step_issues_fewer_ops(calltime):
    cfg, video = _cfg(), _video()

    def step_ops():
        net = _net()
        state, _ = _rollout(net, cfg, video, steps=2)
        return _compute_ops(lambda: core.step(net, state, video[0][3], cfg))

    cached = step_ops()
    calltime()
    today = step_ops()
    assert "aten::rsqrt" in today
    assert "aten::rsqrt" not in cached
    assert len(cached) <= 0.55 * len(today), (len(cached), len(today))
