"""The port's SAM / SAM-HQ (`vosesam_tpu_torch/models/sam/`), its layers and
resizes against the JAX package on the CPU, fp32.

Both sides get the same weights (the JAX `sam_init`, converted by the
port's `params_from_jax`) and the same numpy inputs. The ViT runs at
TINY_SAM widths (`tests/test_pipeline.py:23-26`); the official-square gear
runs at image_size 256 so that the JAX global block goes through its Pallas
flash kernel in interpret mode (a 16x16 grid), and the port's through B3's
plain version. Tolerances: encoder outputs within 1e-4 (fp32 summation
order); decoder low-res logits within atol 1e-3 / rtol 1e-4 and IoU within
1e-4; resizes within 1e-5; the nearest resize and the weight conversions
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import vosesam_tpu.config as jconfig
from vosesam_tpu.config import SAMConfig as JSAMConfig
from vosesam_tpu.models import layers as jlayers
from vosesam_tpu.models.sam import image_encoder as jenc
from vosesam_tpu.models.sam import predictor as jpred
from vosesam_tpu.ops import image as jimage
from vosesam_tpu.utils.checkpoint import tree_to_state_dict
import vosesam_tpu_torch.config as tconfig
from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.models import layers as tlayers
from vosesam_tpu_torch.models.sam import image_encoder as tenc
from vosesam_tpu_torch.models.sam import predictor as tpred
from vosesam_tpu_torch.ops import image as timage
from vosesam_tpu_torch.ops.kernels import flash_attention as tfa
from vosesam_tpu_torch.utils.checkpoint import load_sam_checkpoint, params_from_jax

TINY = dict(model_type="vit_b", window_size=7, vit_dims=(("vit_b", 64, 2, 2, (1,)),))
ENC_TOL = 1e-4
H, W = 48, 64

GEARS = {
    "square": dict(image_size=256),
    "rect": dict(image_size=128, encode_rect=True),
    "fixed": dict(image_size=128, encode_fixed_hw=(64, 96)),
    "letterbox": dict(image_size=128, encode_letterbox_hw=(64, 112)),
}


def _cfgs(**kw):
    return JSAMConfig(**TINY, **kw), SAMConfig(**TINY, **kw)


def _models(jc, tc, seed=1):
    params = jpred.sam_init(jax.random.PRNGKey(seed), jc)
    sam = tpred.Sam(tc)
    sam.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return params, sam.eval()


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(0).integers(0, 255, (H, W, 3), np.uint8)


@pytest.mark.parametrize("gear", sorted(GEARS))
def test_encoder_matches_jax(gear, frame):
    jc, tc = _cfgs(hq=True, **GEARS[gear])
    params, sam = _models(jc, tc)
    je = jpred.encode_image(params, jnp.asarray(frame), jc)
    tfa.reset_counts()
    te = tpred.encode_image(sam, torch.from_numpy(frame)[None], tc)
    assert te.input_hw == tuple(je.input_hw) and te.orig_hw == (H, W)
    assert tfa.COUNTS["plain"] == 1          # the one global block, on the CPU
    np.testing.assert_allclose(te.embedding[0].numpy(), np.asarray(je.embedding),
                               atol=ENC_TOL, rtol=ENC_TOL)
    np.testing.assert_allclose(te.interm[0].numpy(), np.asarray(je.interm),
                               atol=ENC_TOL, rtol=ENC_TOL)


def test_encoder_batch_equals_single_frames(frame):
    jc, tc = _cfgs(image_size=128, encode_rect=True)
    _, sam = _models(jc, tc)
    f2 = np.stack([frame, frame[::-1].copy()])
    batch = tpred.encode_image(sam, torch.from_numpy(f2), tc).embedding
    for i in range(2):
        one = tpred.encode_image(sam, torch.from_numpy(f2[i])[None], tc).embedding[0]
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(), atol=1e-5, rtol=1e-5)


def test_pallas_window_impls_raise():
    _, tc = _cfgs(image_size=128, windowed_attention_impl="pallas_mh")
    sam = tpred.Sam(tc)
    with pytest.raises(NotImplementedError, match="B4/B5"):
        tpred.encode_image(sam, torch.zeros((1, H, W, 3), dtype=torch.uint8), tc)


@pytest.mark.parametrize("impl", ["xla", "xla_fused_bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_attention_matches_jax(impl, dtype):
    """One windowed block's attention (4 windows of 7x7, 2 heads, random
    rel-pos tables) in each XLA impl; in bf16 the port rounds where JAX
    does, so the outputs agree to about one bf16 ulp. The linear layers
    have no bias here: JAX rounds x.W before adding it, torch after."""
    jc, tc = _cfgs(image_size=128, windowed_attention_impl=impl)
    params, sam = _models(jc, tc)
    rng = np.random.default_rng(5)
    pj = dict(params.image_encoder["blocks"]["0"]["attn"])
    for name in ("rel_pos_h", "rel_pos_w"):
        pj[name] = rng.standard_normal(np.shape(pj[name])).astype(np.float32)
    for name in ("qkv", "proj"):
        pj[name] = dict(pj[name], bias=np.zeros(np.shape(pj[name]["bias"]), np.float32))
    attn = sam.image_encoder.blocks[0].attn
    attn.rel_pos_h.data = torch.from_numpy(pj["rel_pos_h"])
    attn.rel_pos_w.data = torch.from_numpy(pj["rel_pos_w"])
    attn.qkv.bias.data.zero_()
    attn.proj.bias.data.zero_()
    x = 2 * rng.standard_normal((4, 7, 7, 64)).astype(np.float32)
    dj, dt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jenc._attention(
        jnp.asarray(x, dj), jax.tree.map(lambda a: jnp.asarray(a, dj), pj), 2, (7, 7),
        windowed_impl=impl).astype(jnp.float32))
    with torch.no_grad():
        got = tenc._attention(torch.from_numpy(x).to(dt), attn.to(dt), (7, 7), False, tc)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("hq,use_mask", [(True, False), (True, True), (False, False),
                                         (False, True)])
def test_decoder_matches_jax(hq, use_mask, frame):
    jc, tc = _cfgs(hq=hq, image_size=128, encode_rect=True)
    params, sam = _models(jc, tc)
    je = jpred.encode_image(params, jnp.asarray(frame), jc)
    te = tpred.encode_image(sam, torch.from_numpy(frame)[None], tc)
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 48, (3, 6, 2)).astype(np.float32)
    labels = np.array([[1, 0, 2, 3, -1, -1], [1, 1, 0, -1, -1, -1],
                       [-1, -1, -1, -1, -1, -1]], np.int32)
    grid = np.asarray(je.embedding).shape[:2]
    mask = (rng.standard_normal((3, grid[0] * 4, grid[1] * 4)).astype(np.float32)
            if use_mask else None)
    tl, ti = tpred.predict_low_res(
        sam, te, torch.from_numpy(coords), torch.from_numpy(labels).long(),
        None if mask is None else torch.from_numpy(mask), tc)
    for i in range(3):
        jl, ji = jpred.predict_low_res(params, je, jnp.asarray(coords[i]),
                                       jnp.asarray(labels[i]),
                                       None if mask is None else jnp.asarray(mask[i]), jc)
        assert tl.shape[1] == (5 if hq else 4)
        np.testing.assert_allclose(tl[i].numpy(), np.asarray(jl), atol=1e-3, rtol=1e-4)
        np.testing.assert_allclose(ti[i].numpy(), np.asarray(ji), atol=1e-4, rtol=1e-4)
    tok = tpred.select_token(ti, tc, False)
    assert tok.tolist() == [4 if hq else 0] * 3


def test_postprocess_and_resizes_at_480p():
    rng = np.random.default_rng(2)
    low = rng.standard_normal((2, 144, 256)).astype(np.float32)
    want = np.asarray(jpred.postprocess_masks(jnp.asarray(low), (576, 1024), (480, 854),
                                              JSAMConfig()))
    got = tpred.postprocess_masks(torch.from_numpy(low), (576, 1024), (480, 854)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    logits = (10 * rng.standard_normal((2, 480, 854))).astype(np.float32)
    want = np.stack([np.asarray(jimage.resize_mask_prompt(jnp.asarray(x), (144, 256)))
                     for x in logits])
    got = timage.resize_mask_prompt(torch.from_numpy(logits), (144, 256)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    img = rng.integers(0, 255, (480, 854, 3)).astype(np.float32)
    want, whw = jimage.sam_input_resize(jnp.asarray(img), 1024, rect=True)
    got, thw = timage.sam_input_resize(torch.from_numpy(img), 1024, rect=True)
    assert tuple(whw) == thw == (576, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * 255, rtol=1e-5)
    labels = rng.integers(0, 40, (120, 213)).astype(np.int32)
    np.testing.assert_array_equal(
        timage.resize_nearest(torch.from_numpy(labels), (480, 854), axes=(0, 1)).numpy(),
        np.asarray(jimage.resize_nearest(jnp.asarray(labels), (480, 854), axes=(0, 1))))


@pytest.mark.parametrize("n_in,n_out", [(854, 256), (480, 144), (144, 576), (1024, 854),
                                        (64, 28), (7, 7)])
def test_linear_resize_weights_match_jax(n_in, n_out):
    x = np.eye(n_in, dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out, n_in), "linear"))
    np.testing.assert_allclose(timage.linear_resize_weights(n_in, n_out) if n_in != n_out
                               else np.eye(n_in), want, atol=1e-6)


def test_layers_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    # conv-transpose: JAX HWIO kernel vs the official IOHW ConvTranspose2d
    w = rng.standard_normal((2, 2, 8, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    want = np.asarray(jlayers.conv_transpose2d(jnp.asarray(x), {"weight": w, "bias": b},
                                               stride=2, padding=0))
    ct = nn.ConvTranspose2d(8, 3, 2, stride=2)
    sd = params_from_jax({"mask_decoder": {"output_upscaling": {"0": {"weight": w, "bias": b}}}})
    ct.weight.data = sd["mask_decoder.output_upscaling.0.weight"]
    ct.bias.data = sd["mask_decoder.output_upscaling.0.bias"]
    got = tlayers.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), ct)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want, atol=1e-5)
    ln = nn.LayerNorm(8)
    ln.weight.data.uniform_(0.5, 1.5)
    ln.bias.data.uniform_(-1, 1)
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x), {"weight": ln.weight.detach().numpy(),
                                                          "bias": ln.bias.detach().numpy()}))
    np.testing.assert_allclose(tlayers.layer_norm(torch.from_numpy(x), ln).detach().numpy(),
                               want, atol=1e-5)
    for dt_j, dt_t, tol in ((jnp.float32, torch.float32, 1e-6),
                            (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = np.asarray(jlayers.gelu_fast(jnp.asarray(x, dt_j)).astype(jnp.float32))
        got = tlayers.gelu_fast(torch.from_numpy(x).to(dt_t)).float().numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_sam_checkpoint_round_trip(tmp_path):
    """A synthetic official-schema SAM-HQ dict, written by the JAX package's
    tree_to_state_dict, loads strictly and equals params_from_jax."""
    jc, tc = _cfgs(hq=True, image_size=128)
    params = jax.tree.map(np.asarray, jpred.sam_init(jax.random.PRNGKey(3), jc))
    convt = {f"mask_decoder.{m}.{i}.weight": "conv_transpose"
             for m in ("output_upscaling", "compress_vit_feat", "embedding_encoder")
             for i in (0, 3)}
    sd = tree_to_state_dict(params._asdict(), transpose_spec=convt)
    path = tmp_path / "sam_hq_synthetic.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    loaded = load_sam_checkpoint(str(path))
    sam = tpred.Sam(tc)
    sam.load_state_dict(loaded, strict=True)
    ref = params_from_jax(params)
    assert loaded.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(loaded[k].numpy(), ref[k].numpy(), err_msg=k)
    assert loaded["mask_decoder.output_upscaling.0.weight"].shape == (256, 64, 2, 2)
    assert loaded["mask_decoder.iou_token.weight"].shape == (1, 256)


def test_sam_init_covers_every_weight():
    _, tc = _cfgs(hq=True, image_size=128)
    sam = tpred.sam_init(tc, seed=1, device="cpu")
    for name, t in list(sam.named_parameters()) + list(sam.named_buffers()):
        assert torch.isfinite(t).all(), name
    again = tpred.sam_init(tc, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(sam.parameters(), again.parameters()))


@pytest.mark.parametrize("name", ["MemoryConfig", "XMemConfig", "SAMConfig", "RefinementConfig",
                                  "InpainterConfig", "ParallelConfig", "FrameworkConfig"])
def test_config_copy_matches_jax(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tconfig, name))}
    assert jf.keys() == tf.keys()
    for k in jf:
        assert repr(jf[k]) == repr(tf[k]), k
