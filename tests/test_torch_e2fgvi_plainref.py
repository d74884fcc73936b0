"""The port's E2FGVI-HQ generator against the benchmark's plain reference
(`benchmark/reference/plainref/models/e2fgvi`, the published model in plain
PyTorch, float32, channel-first), at a small size on the CPU, on one seeded
random state dict loaded strictly into both:

  - `generator_forward` (prediction and flows) within a relative error of
    1e-5 of the reference, a window of 7 slots (5 local) at 60x108, with and
    without a padded reference slot. Both sides compute in float32 on the
    CPU and differ only in the order of their sums (measured ~5e-7);
  - the reference with every product's operands in bfloat16 (the
    benchmark's control) misses that tolerance, prediction and flows alike,
    so the comparison can tell the precision the configuration states from
    the one below;
  - the port at the JAX package's two roundings (LayerNorm eps 1e-6, an
    antialiased resize of the flows back from SPyNet's multiple of 32)
    misses it too: the reference holds the port to the published code's
    roundings, and a departure of that size shows;
  - a padded slot changes nothing for the valid frames (the reference on the
    window without it);
  - the inpainter's profiler spans appear around a tiny `Inpainter.inpaint`;
  - the generator refuses a config whose widths are not the checkpoint's.
"""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import InpainterConfig
from vosesam_tpu_torch.models.e2fgvi import generator as G
from vosesam_tpu_torch.pipeline.inpaint import Inpainter

_BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
for _p in (_BENCH, os.path.join(_BENCH, "reference")):
    if _p not in sys.path:
        sys.path.append(_p)

from harness import registry  # noqa: E402
from plainref.models.e2fgvi import generator as R  # noqa: E402

T, LT, H, W = 7, 5, 60, 108
BLOCKS = 2
TOL = 1e-5


def seeded_state_dict(module: torch.nn.Module, seed: int):
    """Random weights under `module`'s names: 1-D weights (the norms') 1,
    biases N(0, 0.02), every other weight N(0, 1 / (3 fan_in))."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        if v.ndim == 1 and k.endswith("weight"):
            out[k] = torch.ones(v.shape)
        elif v.ndim == 1:
            out[k] = 0.02 * torch.randn(v.shape, generator=g)
        else:
            fan_in = int(np.prod(v.shape[1:]))
            out[k] = torch.randn(v.shape, generator=g) / np.sqrt(3.0 * fan_in)
    return out


def relerr(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def nets():
    with torch.device("meta"):
        ref = R.InpaintGenerator(R.E2FGVIConfig(num_blocks=BLOCKS))
        port = G.InpaintGenerator(InpainterConfig(num_blocks=BLOCKS))
    sd = seeded_state_dict(ref, 20260517)
    ref.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    port.load_state_dict(sd, strict=True, assign=True)
    return port.eval(), ref.eval(), sd


@pytest.fixture(scope="module")
def window():
    g = torch.Generator().manual_seed(7)
    return torch.rand((1, T, H, W, 3), generator=g) * 2 - 1


def _valid(padded: bool):
    return torch.tensor([[True] * (T - 1) + [not padded]])


def _port(port, x, valid):
    with torch.no_grad():
        out, (ff, fb) = G.generator_forward(port, x, LT, InpainterConfig(num_blocks=BLOCKS),
                                            frame_valid=valid)
    return out, ff, fb


def _ref(ref, x, valid):
    with torch.no_grad():
        out, (ff, fb) = R.forward(ref, x.permute(0, 1, 4, 2, 3), LT, valid)
    return out.permute(0, 1, 3, 4, 2), ff.permute(0, 1, 3, 4, 2), fb.permute(0, 1, 3, 4, 2)


def _gaps(a, b, valid):
    sel = valid[0]
    return (relerr(a[0][:, sel], b[0][:, sel]), relerr(a[1], b[1]), relerr(a[2], b[2]))


@pytest.mark.parametrize("padded", [False, True], ids=["all_valid", "padded_slot"])
def test_generator_matches_the_plain_reference(nets, window, padded):
    port, ref, _ = nets
    valid = _valid(padded)
    gaps = _gaps(_port(port, window, valid), _ref(ref, window, valid), valid)
    assert max(gaps) < TOL, gaps


def test_reference_with_bfloat16_products_misses_the_tolerance(nets, window):
    port, ref, _ = nets
    valid = _valid(True)
    with registry.driver("inpaint").Bfloat16Products():
        got = _ref(ref, window, valid)
    gaps = _gaps(got, _port(port, window, valid), valid)
    assert min(gaps) > TOL, gaps


def test_the_jax_packages_roundings_miss_the_tolerance(nets, window, monkeypatch):
    port, ref, _ = nets
    monkeypatch.setattr(G, "LN_EPS", 1e-6)
    monkeypatch.setattr(G, "F", types.SimpleNamespace(
        interpolate=functools.partial(torch.nn.functional.interpolate, antialias=True)))
    valid = _valid(False)
    out, ff, fb = _gaps(_port(port, window, valid), _ref(ref, window, valid), valid)
    assert out > TOL and ff > TOL and fb > TOL
    assert max(out, ff, fb) < 1e-2


def test_a_padded_slot_changes_no_valid_frame(nets, window):
    _, ref, _ = nets
    padded = _ref(ref, window, _valid(True))[0][:, :T - 1]
    alone = _ref(ref, window[:, :T - 1], None)[0]
    assert relerr(padded, alone) < TOL


def test_inpainter_spans_under_a_cpu_profiler():
    names = ("inpaint.video", "inpaint.prepare", "inpaint.predict", "e2fgvi.flow",
             "e2fgvi.encode", "e2fgvi.propagate", "e2fgvi.transformer", "e2fgvi.decode",
             "inpaint.composite", "inpaint.download")
    inp = Inpainter(cfg=InpainterConfig(num_blocks=1), device="cpu", seed=3)
    r = np.random.default_rng(0)
    frames = [r.integers(0, 255, (H, W, 3), np.uint8) for _ in range(8)]
    masks = [np.zeros((H, W), np.uint8) for _ in range(8)]
    for m in masks:
        m[20:40, 30:70] = 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = inp.inpaint(frames, masks)
    assert len(out) == 8
    seen = {e.name[len("layer::"):]: e for e in prof.events() if e.name.startswith("layer::")}
    assert set(names) <= set(seen), sorted(seen)
    video = seen["inpaint.video"].time_range
    predict = [e.time_range for e in prof.events() if e.name == "layer::inpaint.predict"]
    for name in names[3:8]:
        for e in (e for e in prof.events() if e.name == "layer::" + name):
            assert any(p.start <= e.time_range.start and e.time_range.end <= p.end
                       for p in predict), name
    assert all(video.start <= e.time_range.start and e.time_range.end <= video.end
               for e in prof.events() if e.name.startswith("layer::"))


@pytest.mark.parametrize("field,value", [("hidden_dim", 256), ("num_heads", 8),
                                         ("window_size", (7, 7)), ("focal_level", 3)])
def test_generator_refuses_widths_it_does_not_build(field, value):
    cfg = InpainterConfig(**{field: value})
    with pytest.raises(ValueError, match=field):
        with torch.device("meta"):
            G.InpaintGenerator(cfg)
    with torch.device("meta"):
        G.InpaintGenerator(InpainterConfig())
