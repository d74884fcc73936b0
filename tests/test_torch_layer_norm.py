"""LayerNorm with an optional residual (`ops/kernels/layer_norm.py`,
`models/layers.layer_norm`).

On the CPU: every width the port runs (1280 SAM's encoder, 512 E2FGVI's
focal blocks, 256 SAM's decoder and neck, 16 a toy), bf16 and fp32, eps
1e-6 and 1e-5: CPU inputs, channel-strided views too, take the plain chain
and count under `plain`, bit-equal to the chain the port ran before the
kernel; `layer_norm(x, ln, residual=r)` equals `layer_norm(x + r, ln)` bit
for bit, its sum too. The launch plan (`layout`) is checked without a card:
the instance per dtype and width and the inputs with none, the rows of the
encoder's `window_unpartition` residual as three strided leading dims (each
row's offset as the kernel computes it), 16-byte packs only where pointers
and strides allow. Every LayerNorm of a SAM-HQ encode and decode (a mask
prompt too) has an instance, as the card needs: there an input without one
raises.

On the card (marker `cuda`; `python -m pytest tests/test_torch_layer_norm.py
-m cuda --noconftest`): the kernel against the plain chain (sum bit-equal,
normed within 1e-6 of the row's largest value, plus 1 ulp in bf16) at the
same widths and at the widest, three-leading-dim and empty shapes; the
strided residual of a 64x64-token `window_unpartition` at C 1280; a whole
vit_h `vit_encode` at the 1024 square, batch 2, with the kernel and without
it; grad mode keeps the chain; inputs the kernel has no instance for raise,
through `layers.layer_norm` too.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from vosesam_tpu_torch.models import layers
from vosesam_tpu_torch.models.sam import image_encoder as enc
from vosesam_tpu_torch.ops.kernels import layer_norm as lnk

WIDTHS = (1280, 512, 256, 16)
DTYPES = (torch.bfloat16, torch.float32)
EPSES = (1e-6, 1e-5)


def _chain(x, ln, eps):
    """The expression the port ran before the kernel."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * ln.weight.float() + ln.bias.float()).to(x.dtype)


def _ln(c, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    ln = nn.LayerNorm(c)
    with torch.no_grad():
        ln.weight.copy_(0.5 + torch.rand(c, generator=g))
        ln.bias.copy_(torch.rand(c, generator=g) - 0.5)
    return ln.to(device)


def _rand(shape, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (3.0 + 2.0 * torch.randn(shape, generator=g)).to(dtype).to(device)


@pytest.fixture
def counts():
    lnk.reset_counts()
    yield lnk.COUNTS
    lnk.reset_counts()


# ------------------------------------------------------------------ the CPU

@pytest.mark.parametrize("eps", EPSES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", WIDTHS)
def test_cpu_and_channel_strided_inputs_take_the_plain_chain(c, dtype, eps, counts):
    ln = _ln(c)
    x = _rand((2, 3, c), dtype, 1)
    strided = _rand((2, c, 3), dtype, 2).transpose(1, 2)
    with torch.no_grad():
        w, b = ln.weight.float(), ln.bias.float()
        assert lnk.layout(strided, w, b) is None
        for t in (x, strided):
            assert torch.equal(layers.layer_norm(t, ln, eps), _chain(t, ln, eps))
    assert counts == {"layer_norm": 0, "plain": 2}


@pytest.mark.parametrize("eps", EPSES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", WIDTHS)
def test_cpu_residual_equals_adding_it_first(c, dtype, eps, counts):
    ln = _ln(c, seed=1)
    x = _rand((2, 5, 7, c), dtype, 3)
    r = _rand((2, 6, 9, c), dtype, 4)[:, :5, :7]         # token strides, dense channels
    with torch.no_grad():
        y, s = layers.layer_norm(x, ln, eps, residual=r)
        assert torch.equal(s, x + r)
        assert torch.equal(y, layers.layer_norm(x + r, ln, eps))
        assert torch.equal(y, _chain(x + r, ln, eps))
    assert y.dtype == s.dtype == dtype
    assert counts == {"layer_norm": 0, "plain": 2}


def test_the_fused_wrapper_on_the_cpu_is_the_plain_version(counts):
    ln = _ln(64)
    x, r = _rand((4, 64), torch.bfloat16, 5), _rand((4, 64), torch.bfloat16, 6)
    w, b = ln.weight.detach(), ln.bias.detach()
    y, s = lnk.layer_norm_fused(x, w, b, 1e-6, r)
    assert torch.equal(s, x + r) and torch.equal(y, _chain(x + r, ln, 1e-6))
    y, s = lnk.layer_norm_fused(x, w, b, 1e-6)
    assert s is x and torch.equal(y, _chain(x, ln, 1e-6))
    assert counts == {"layer_norm": 0, "plain": 2}


@pytest.mark.parametrize("dtype, c, packs", [
    (torch.bfloat16, 1280, 5), (torch.float32, 1280, 10),
    (torch.float32, 512, 4), (torch.bfloat16, 512, 2),
    (torch.bfloat16, 256, 1), (torch.float32, 256, 2),
    (torch.bfloat16, 16, 1), (torch.float32, 16, 1),
    (torch.float32, 4, 1), (torch.bfloat16, 768, 3),
    (torch.float32, 1024, 8), (torch.bfloat16, 4, None),
    (torch.bfloat16, 37, None), (torch.float32, 1023, None),
    (torch.bfloat16, 1288, None), (torch.float32, 1284, None),
    (torch.float16, 256, None),
])
def test_layout_picks_the_instance(dtype, c, packs):
    x = torch.zeros((3, c), dtype=dtype)
    w, b = torch.ones(c), torch.zeros(c)
    got = lnk.layout(x, w, b)
    assert (None if got is None else got.packs) == packs
    if packs is not None:
        vec = 16 // x.element_size()
        assert packs * 32 * vec >= c > (packs - 1) * 32 * vec
        assert packs * vec <= lnk.MAX_VALUES


def _row_offsets(plan, which, rows):
    """Each row's element offset as the kernel's `row_offset` computes it."""
    s = plan.strides[3 * which: 3 * which + 3]
    r = np.asarray(rows, dtype=np.int64)
    i2, q = r % plan.d2, r // plan.d2
    return (q // plan.d1) * s[0] + (q % plan.d1) * s[1] + i2 * s[2]


def test_layout_of_the_window_unpartition_residual():
    c, wsz, b = 16, 14, 2
    x = torch.zeros((b, 64, 64, c), dtype=torch.bfloat16)
    parts, pad_hw = enc.window_partition(torch.randn((b, 64, 64, c)).to(torch.bfloat16), wsz)
    y = enc.window_unpartition(parts, wsz, pad_hw, (64, 64))
    assert pad_hw == (70, 70) and not y.is_contiguous() and y.stride(-1) == 1
    plan = lnk.layout(x, torch.ones(c), torch.zeros(c), residual=y)
    assert plan.rows == b * 64 * 64 and (plan.d1, plan.d2) == (64, 64)
    assert plan.strides == (64 * 64 * c, 64 * c, c, 70 * 70 * c, 70 * c, c)
    assert plan.packs == 1
    rows = np.arange(plan.rows)
    storage = y.as_strided((y.untyped_storage().nbytes() // y.element_size(),), (1,), 0)
    offs = torch.from_numpy(_row_offsets(plan, 1, rows) + y.storage_offset())
    assert torch.equal(storage[offs[:, None] + torch.arange(c)], y.reshape(-1, c))
    assert np.array_equal(_row_offsets(plan, 0, rows), rows * c)


def test_layout_packs_only_where_pointers_and_strides_allow():
    c = 256
    w, b = torch.ones(c), torch.zeros(c)
    big = torch.zeros((4, c + 8), dtype=torch.bfloat16)
    assert lnk.layout(big[:, :c], w, b) is not None          # row stride c + 8: 16-byte steps
    assert lnk.layout(big[:, 8:c + 8], w, b) is not None     # 16 bytes on
    assert lnk.layout(big[:, 1:c + 1], w, b) is None         # 2 bytes off
    odd = torch.zeros((4, c + 3), dtype=torch.bfloat16)
    assert lnk.layout(odd[:, :c], w, b) is None              # row stride not a pack
    assert lnk.layout(big[:, :c], torch.ones(c + 4)[4:], b) is not None   # weight 16 bytes on
    assert lnk.layout(big[:, :c], torch.ones(c + 1)[1:], b) is None       # weight 4 bytes off
    assert lnk.layout(big[:, :c], w.double(), b) is None
    five = torch.zeros((2, 3, 4, 5, 6, c))[:, :, ::2, :, ::2]
    assert lnk.layout(five.permute(1, 0, 2, 3, 4, 5), w, b) is None   # four leading dims left
    assert lnk.layout(torch.zeros((2, 3, 0)), torch.ones(0), torch.zeros(0)) is None
    empty = lnk.layout(torch.zeros((0, 3, c)), w, b)
    assert empty.rows == 0


@pytest.mark.parametrize("rect", [False, True])
def test_every_block_layer_norm_sees_a_dense_channel_axis(rect, monkeypatch):
    """A rect frame that needs no padding comes out of `preprocess` planar
    in memory; the encoder still hands each block's two LayerNorms (and the
    neck's) a dense channel axis, which the kernel needs."""
    from vosesam_tpu_torch.config import SAMConfig
    from vosesam_tpu_torch.models.sam import predictor

    cfg = SAMConfig(model_type="vit_b", image_size=128, window_size=7, encode_rect=rect,
                    vit_dims=(("vit_b", 64, 2, 2, (1,)),))
    torch.manual_seed(0)
    model = enc.ImageEncoderViT(cfg).eval()
    x, _ = predictor.preprocess(torch.zeros((1, 48, 64, 3), dtype=torch.uint8), cfg)
    assert x.is_contiguous() is not rect
    seen = []
    fused = lnk.layer_norm_fused

    def spy(t, w, b, eps, residual=None):
        seen.append((t.shape[-1], lnk.layout(t, w, b, residual) is not None))
        return fused(t, w, b, eps, residual)

    monkeypatch.setattr(lnk, "layer_norm_fused", spy)
    with torch.no_grad():
        enc.vit_encode(model, x.to(torch.bfloat16))
    assert seen == [(64, True)] * 4 + [(256, True)] * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_layer_norm_of_an_hq_encode_and_decode_has_an_instance(dtype, monkeypatch):
    """The card raises for a LayerNorm input the kernel has no instance
    for. Every one of a SAM-HQ encode and of a decode with points and a mask
    prompt has one: the tokens as they come, each LayerNorm2d's channel-last
    view as `layer_norm_chw` hands it over on the card (copied dense)."""
    from vosesam_tpu_torch.config import SAMConfig
    from vosesam_tpu_torch.models.sam import predictor

    cfg = SAMConfig(model_type="vit_b", image_size=128, window_size=7, hq=True,
                    vit_dims=(("vit_b", 64, 2, 2, (1,)),))
    sam = predictor.sam_init(cfg, device="cpu", dtype=dtype)
    seen, chw = [], []
    fused, to_chw = lnk.layer_norm_fused, layers.layer_norm_chw

    def spy(t, w, b, eps, residual=None):
        if not chw or chw[-1] is not None:
            seen.append((tuple(t.shape), lnk.layout(t, w, b, residual) is not None))
        return fused(t, w, b, eps, residual)

    def spy_chw(x, ln, eps=1e-6):
        chw.append(None)                    # the inner layer_norm call is this one's
        dense = x.permute(0, 2, 3, 1).contiguous()
        w, b = ln.weight.float(), ln.bias.float()
        out = to_chw(x, ln, eps)
        chw[-1] = (tuple(dense.shape), lnk.layout(dense, w, b) is not None)
        return out

    monkeypatch.setattr(lnk, "layer_norm_fused", spy)
    for mod in ("mask_decoder", "prompt_encoder"):
        monkeypatch.setattr(f"vosesam_tpu_torch.models.sam.{mod}.layer_norm_chw", spy_chw)
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 255, (1, 96, 128, 3), generator=g, dtype=torch.uint8)
    with torch.no_grad():
        emb = predictor.encode_image(sam, img, cfg)
        coords = torch.tensor([[[40.0, 30.0], [90.0, 60.0]]])
        labels = torch.tensor([[1, 0]])
        low, _ = predictor.predict_low_res(sam, emb, coords, labels, None, cfg)
        predictor.predict_low_res(sam, emb, coords, labels, low[:, 0], cfg)
    widths = {shape[-1] for shape, _ in seen} | {shape[-1] for shape, _ in chw}
    assert {64, 256, 4, 16} <= widths
    assert len(chw) >= 4 and all(ok for _, ok in seen + chw), [s for s in seen + chw if not s[1]]


@pytest.mark.parametrize("batched", [False, True])
def test_every_focal_block_layer_norm_has_an_instance(batched, monkeypatch):
    """E2FGVI-HQ's focal blocks (fp32, C 512, eps 1e-5) hand every
    LayerNorm an input the kernel has an instance for, one window or a
    batch of windows with a padded slot."""
    from vosesam_tpu_torch.config import InpainterConfig
    from vosesam_tpu_torch.models.e2fgvi import generator as G

    cfg = InpainterConfig(num_blocks=2)
    torch.manual_seed(0)
    net = G.InpaintGenerator(cfg).eval()
    seen = []
    fused = lnk.layer_norm_fused

    def spy(t, w, b, eps, residual=None):
        seen.append((t.shape[-1], t.dtype, eps, lnk.layout(t, w, b, residual) is not None))
        return fused(t, w, b, eps, residual)

    monkeypatch.setattr(lnk, "layer_norm_fused", spy)
    frames = torch.rand((2, 5, 60, 108, 3) if batched else (5, 60, 108, 3)) * 2 - 1
    valid = torch.tensor([[True] * 5, [True] * 4 + [False]]) if batched else None
    with torch.no_grad():
        G.generator_forward(net, frames, 3, cfg, frame_valid=valid)
    assert seen == [(G.HIDDEN, torch.float32, G.LN_EPS, True)] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_parameters_in_one_flat_buffer_keep_an_instance(dtype, counts):
    """Parameters loaded as views into one flat buffer (`load_state_dict(...,
    assign=True)` of `torch.split` parts, as a benchmark or a checkpoint
    reader hands them over) sit at any offset; `layers.layer_norm` hands the
    kernel 16-byte aligned fp32 copies of those that are off, with the same
    values, and the result stays bit-equal to the chain."""
    c = 512
    ln = _ln(c, seed=5).to(dtype)
    flat = torch.zeros(2 * c + 1, dtype=dtype)
    w_view, b_view = torch.split(flat[1:], (c, c))
    w_view.copy_(ln.weight.detach())
    b_view.copy_(ln.bias.detach())
    ln.load_state_dict({"weight": w_view, "bias": b_view}, assign=True)
    assert ln.weight.data_ptr() % 16 != 0
    w, b = lnk.affine(ln.weight, ln.bias)
    assert w.dtype == b.dtype == torch.float32
    assert w.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    assert torch.equal(w, ln.weight.float()) and torch.equal(b, ln.bias.float())
    x = _rand((3, 5, c), torch.float32, 15)
    assert lnk.layout(x, w, b) is not None
    aligned = _ln(c, seed=5).to(dtype)
    assert lnk.affine(aligned.weight, aligned.bias)[0].data_ptr() % 16 == 0
    with torch.no_grad():
        assert torch.equal(layers.layer_norm(x, ln, 1e-5), _chain(x, ln, 1e-5))
    assert counts == {"layer_norm": 0, "plain": 1}


# ----------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _assert_normed_close(got, want):
    """Within 1e-6 of the row's largest value in fp32; in bf16 within one
    bf16 ulp plus that: the two sum the statistics in another order, which
    moves the fp32 value before its rounding by ~1e-7 of the row, more than
    a bf16 ulp of an output that the bias has brought near zero."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.numel() == 0:
        return
    g, w = got.float(), want.float()
    slack = (g - w).abs()
    if got.dtype == torch.bfloat16:
        slack = (slack - _bf16_ulp(torch.maximum(g.abs(), w.abs()))).clamp(min=0)
    rel = (slack / w.abs().amax(dim=-1, keepdim=True)).max().item()
    assert rel <= 1e-6, f"{rel} of the row's largest value past the tolerance"


def _bf16_ulp(t):
    """The spacing of bf16 values at |t| (8 significant bits)."""
    return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 8)


def _both(x, ln, eps, residual=None):
    w, b = ln.weight.float(), ln.bias.float()
    return (lnk.layer_norm_fused(x, w, b, eps, residual),
            lnk.layer_norm_plain(x, w, b, eps, residual))


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("eps", EPSES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", WIDTHS)
def test_kernel_against_the_plain_chain(card, counts, c, dtype, eps, residual):
    ln = _ln(c, seed=2, device=card)
    x = _rand((3, 37, 41, c), dtype, 7, card)
    r = _rand((3, 40, 41, c), dtype, 8, card)[:, 2:39] if residual else None
    with torch.no_grad():
        (y, s), (py, ps) = _both(x, ln, eps, r)
        assert lnk.layout(x, ln.weight.float(), ln.bias.float(), r) is not None
        got = layers.layer_norm(x, ln, eps, residual=r)
    torch.cuda.synchronize()
    assert torch.equal(s, ps)
    _assert_normed_close(y, py)
    assert torch.equal(got[0] if residual else got, y)
    assert counts["layer_norm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape, view", [
    (torch.bfloat16, (5, 1280), None),              # five packs a lane
    (torch.float32, (6, 1280), None),               # ten packs a lane, the widest
    (torch.bfloat16, (7, 768), None),               # vit_b
    (torch.float32, (9, 1024), None),               # vit_l
    (torch.float32, (2, 3, 5, 4, 24), None),        # three leading dims after merging
    (torch.bfloat16, (64, 264), (slice(None), slice(8, 264))),   # 16 bytes on
    (torch.float32, (0, 256), None),
    (torch.bfloat16, (256,), None),
])
def test_kernel_at_wide_odd_and_empty_shapes(card, counts, dtype, shape, view):
    x = _rand(shape, dtype, 9, card)
    if view is not None:
        x = x[view]
    elif len(shape) == 5:
        x = x[:, :, ::2, :, :16]
    c = x.shape[-1]
    ln = _ln(c, seed=3, device=card)
    r = _rand(x.shape, dtype, 10, card)
    with torch.no_grad():
        assert lnk.layout(x, ln.weight.float(), ln.bias.float(), r) is not None
        for res in (None, r):
            (y, s), (py, ps) = _both(x, ln, 1e-6, res)
            torch.cuda.synchronize()
            assert torch.equal(s, ps)
            _assert_normed_close(y, py)


@pytest.mark.cuda
def test_the_window_unpartition_residual_at_64x64_tokens(card, counts):
    c, wsz = 1280, 14
    ln = _ln(c, seed=4, device=card)
    x = _rand((2, 64, 64, c), torch.bfloat16, 11, card)
    parts, pad_hw = enc.window_partition(_rand((2, 64, 64, c), torch.bfloat16, 12, card), wsz)
    y = enc.window_unpartition(parts, wsz, pad_hw, (64, 64))
    assert not y.is_contiguous()
    with torch.no_grad():
        normed, s = layers.layer_norm(x, ln, residual=y)
        (ky, ks), (py, ps) = _both(x, ln, 1e-6, y)
    torch.cuda.synchronize()
    assert torch.equal(s, x + y) and torch.equal(ks, ps) and torch.equal(normed, ky)
    _assert_normed_close(ky, py)
    assert counts["layer_norm"] == 2


def _relerr(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_vit_encode_with_and_without_the_kernel(card, counts, monkeypatch):
    """vit_h at the 1024 square, batch 2, bf16: the kernel moves the
    embedding less than bf16 itself does (the same encode in fp32 through
    the plain chain), and the 64 block LayerNorms all take the kernel."""
    from vosesam_tpu_torch.config import SAMConfig

    torch.manual_seed(0)
    model = enc.ImageEncoderViT(SAMConfig(model_type="vit_h")).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
        model.pos_embed.normal_(0.0, 0.02)
    model = model.to(card)                 # fp32 parameters, as the port keeps them
    img = _rand((2, 1024, 1024, 3), torch.float32, 13, card) - 3.0
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with torch.no_grad():
        got = enc.vit_encode(model, img.to(torch.bfloat16))
        torch.cuda.synchronize()
        assert counts == {"layer_norm": 66, "plain": 0}
        monkeypatch.setattr(lnk, "layer_norm_fused", lnk.layer_norm_plain)
        plain = enc.vit_encode(model, img.to(torch.bfloat16))
        fp32 = enc.vit_encode(model, img)
    torch.cuda.synchronize()
    kernel_vs_plain, bf16_vs_fp32 = _relerr(got, plain), _relerr(plain, fp32)
    assert kernel_vs_plain < bf16_vs_fp32, (kernel_vs_plain, bf16_vs_fp32)


@pytest.mark.cuda
def test_grad_mode_keeps_the_plain_chain(card, counts):
    ln = _ln(256, device=card)
    x = _rand((4, 256), torch.float32, 14, card).requires_grad_()
    y = layers.layer_norm(x, ln)
    y.square().sum().backward()
    assert x.grad is not None and ln.weight.grad is not None
    assert counts == {"layer_norm": 0, "plain": 1}
    with pytest.raises(RuntimeError, match="no backward"):
        lnk.layer_norm_fused(x, ln.weight, ln.bias, 1e-6)


@pytest.mark.cuda
def test_inputs_without_an_instance_raise(card, counts):
    w, b = torch.ones(256, device=card), torch.zeros(256, device=card)
    with torch.no_grad():
        for x in (torch.zeros((4, 256), dtype=torch.float16, device=card),
                  torch.zeros((256, 4), device=card).t(),
                  torch.zeros((4, 512), device=card),
                  torch.zeros((4, 264), dtype=torch.bfloat16, device=card)[:, 1:257]):
            with pytest.raises(ValueError, match="no kernel instance"):
                lnk.layer_norm_fused(x, w, b, 1e-6)
        ln = _ln(64, device=card)
        strided = torch.zeros((2, 64, 8, 8), device=card).permute(0, 2, 3, 1)
        with pytest.raises(ValueError, match="no kernel instance"):
            layers.layer_norm(strided, ln)          # no quiet chain on the card
        chw = layers.layer_norm_chw(strided.permute(0, 3, 1, 2), ln)   # copied dense
    assert chw.shape == (2, 64, 8, 8)
    assert counts == {"layer_norm": 1, "plain": 0}
