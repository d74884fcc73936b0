"""Tensor parallelism of the SAM image encoder (`parallel/mesh.py:
shard_sam_params_tp`, ROADMAP A13b) against JAX's (`tests/test_parallel.py`
`test_sam_tp_sharding`, `test_tp_vit_encode_matches_single_device`).

The port runs gloo ranks on the CPU (`run_ranks`), spawned twice: 2 ranks,
first as a (2 data x 1 model) mesh (the input comes back: bit-equal
encodes), then as (1 data x 2 model); and 4 ranks as (2 data x 2 model),
where each model group encodes its own image. The encoder is vit_b at
image size 256 with `windowed_attention_impl="xla"` and flash off, fp32,
its weights JAX's `vit_init(PRNGKey(2))` converted by `params_from_jax`, the
images from `PRNGKey(3)` (and `PRNGKey(4)` for the second data index), as in
JAX's test. The spawned ranks import this module by name, so it imports
JAX only inside the tests.

Tolerance: 2e-4 absolute and relative, JAX's own for its TP encode
(`tests/test_parallel.py:111-113`), against the port's unsharded encode and
against JAX's `vit_encode`. The unsharded reference is computed inside the
rank (the thread count changes CPU reduction orders).
"""

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import ParallelConfig, SAMConfig
from vosesam_tpu_torch.models.sam import image_encoder as tenc
from vosesam_tpu_torch.models.sam.predictor import Sam
from vosesam_tpu_torch.parallel import mesh as meshlib

SAM_CFG = dict(model_type="vit_b", image_size=256, use_flash_attention=False,
               windowed_attention_impl="xla")
TOL = 2e-4
SHARDED = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "mlp.lin1.weight",
           "mlp.lin1.bias", "mlp.lin2.weight")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side (and this file
    spawns ranks): keep this process's torch work from taking every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _sam(weights: str) -> Sam:
    sam = Sam(SAMConfig(**SAM_CFG))
    sam.image_encoder.load_state_dict(torch.load(weights), strict=True)
    return sam.eval()


def _encode(sam, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return tenc.vit_encode(sam.image_encoder, torch.from_numpy(x)[None])[0].numpy()


def _model1_body(weights: str, images: np.ndarray):
    """A (2 data x 1 model) mesh: shard_sam_params_tp returns its input."""
    sam = _sam(weights)
    mesh = meshlib.make_mesh(ParallelConfig())
    tp = meshlib.shard_sam_params_tp(sam, mesh, ParallelConfig())
    x = images[mesh.data_index]
    return dict(shape=mesh.shape, model_size=mesh.model_size, same_object=tp is sam,
                bitequal=bool(np.array_equal(_encode(tp, x), _encode(sam, x))))


def _model2_body(weights: str, images: np.ndarray):
    """(world / 2 data x 2 model): this rank's TP encode of its data index's
    image, the unsharded encode beside it (model index 0), and block 0's
    slices and the sharing of every other tensor (the placement)."""
    pcfg = ParallelConfig(model_parallel=2)
    sam = _sam(weights)
    mesh = meshlib.make_mesh(pcfg)
    tp = meshlib.shard_sam_params_tp(sam, mesh, pcfg)
    x = images[mesh.data_index]
    got = _encode(tp, x)
    want = _encode(sam, x) if mesh.model_index == 0 else None
    full = dict(sam.named_parameters())
    local = dict(tp.named_parameters())
    shared = sorted(k for k, v in local.items() if v is full[k])
    blk = tp.image_encoder.blocks[0]
    return dict(
        cell=(mesh.data_index, mesh.model_index), shape=mesh.shape,
        model_group=torch.distributed.get_process_group_ranks(mesh.model_group),
        data_group=torch.distributed.get_process_group_ranks(mesh.data_group),
        got=got, want=want, heads=[b.attn.heads for b in tp.image_encoder.blocks],
        full_heads=sam.image_encoder.blocks[0].attn.heads,
        block0={k: local[f"image_encoder.blocks.0.{k}"].detach().numpy() for k in SHARDED},
        linear_shapes=[tuple(lin.weight.shape) == (lin.out_features, lin.in_features)
                       for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.lin1, blk.mlp.lin2)],
        shared=shared, names=sorted(local))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from vosesam_tpu.config import SAMConfig as JSAMConfig
    from vosesam_tpu.models.sam import image_encoder as jenc
    from vosesam_tpu_torch.utils.checkpoint import params_from_jax

    jc = JSAMConfig(**SAM_CFG)
    params = jenc.vit_init(jax.random.PRNGKey(2), jc)
    images = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(s), (256, 256, 3)) * 0.1)
                       for s in (3, 4)]).astype(np.float32)
    sd = params_from_jax({"image_encoder": jax.tree.map(np.asarray, params)})
    sd = {k[len("image_encoder."):]: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in sd.items()}
    path = str(tmp_path_factory.mktemp("tp") / "vit_b.pth")
    torch.save(sd, path)
    enc = jax.jit(lambda p, x: jenc.vit_encode(p, x, jc))
    jax_out = [np.asarray(enc(params, images[i])) for i in range(2)]
    return path, images, sd, jax_out


@pytest.fixture(scope="module")
def two(setup):
    path, images = setup[:2]
    m1 = meshlib.run_ranks(_model1_body, 2, path, images, device="cpu", timeout_s=120,
                           threads=1)
    return m1, meshlib.run_ranks(_model2_body, 2, path, images, device="cpu", timeout_s=120,
                                 threads=1)


@pytest.fixture(scope="module")
def four(setup):
    path, images = setup[:2]
    return meshlib.run_ranks(_model2_body, 4, path, images, device="cpu", timeout_s=150,
                             threads=1)


# ---------------------------------------------------------------- placement

def test_placement_matches_jax_shard_shapes(setup, two):
    """JAX's test_sam_tp_sharding: qkv column parallel (here by heads: the
    rank's q, k and v rows of its heads, (3C/mp, C) in torch's layout, JAX's
    (C, 3C/mp) transposed), lin2 row parallel ((C, 4C/mp)), the rest
    replicated (the very tensors of the input)."""
    _, sd, _ = setup[1:]
    ranks = two[1]
    c, heads, mp = 768, 12, 2
    hd, hl = c // heads, heads // mp
    for r in ranks:
        m = r["cell"][1]
        b0 = r["block0"]
        assert b0["attn.qkv.weight"].shape == (3 * c // mp, c)
        assert b0["mlp.lin2.weight"].shape == (c, 4 * c // mp)
        heads_rows = np.arange(3 * c).reshape(3, heads, hd)[:, m * hl:(m + 1) * hl].ravel()
        full = {k: sd[f"blocks.0.{k}"].numpy() for k in SHARDED}
        np.testing.assert_array_equal(b0["attn.qkv.weight"], full["attn.qkv.weight"][heads_rows])
        np.testing.assert_array_equal(b0["attn.qkv.bias"], full["attn.qkv.bias"][heads_rows])
        cols = slice(m * hl * hd, (m + 1) * hl * hd)
        np.testing.assert_array_equal(b0["attn.proj.weight"], full["attn.proj.weight"][:, cols])
        hid = slice(m * 4 * c // mp, (m + 1) * 4 * c // mp)
        np.testing.assert_array_equal(b0["mlp.lin1.weight"], full["mlp.lin1.weight"][hid])
        np.testing.assert_array_equal(b0["mlp.lin1.bias"], full["mlp.lin1.bias"][hid])
        np.testing.assert_array_equal(b0["mlp.lin2.weight"], full["mlp.lin2.weight"][:, hid])
        assert r["heads"] == [hl] * 12 and r["full_heads"] == heads
        assert all(r["linear_shapes"])
        sharded = {f"image_encoder.blocks.{i}.{k}" for i in range(12) for k in SHARDED}
        assert set(r["names"]) - set(r["shared"]) == sharded
        assert any(n.startswith("mask_decoder.") for n in r["shared"])
        assert "image_encoder.blocks.0.attn.proj.bias" in r["shared"]
        assert "image_encoder.blocks.0.attn.rel_pos_h" in r["shared"]


def test_heads_that_do_not_divide_raise():
    cfg = SAMConfig(model_type="vit_b", image_size=64, vit_dims=(("vit_b", 48, 2, 3, (1,)),))
    mesh = meshlib.Mesh(np.arange(2).reshape(1, 2), ("data", "model"), 0)
    with pytest.raises(ValueError, match="3 heads"):
        meshlib.shard_sam_params_tp(Sam(cfg), mesh, ParallelConfig(model_parallel=2))
    even = SAMConfig(model_type="vit_b", image_size=64, vit_dims=(("vit_b", 64, 2, 2, (1,)),))
    with pytest.raises(ValueError, match="no process group"):
        meshlib.shard_sam_params_tp(Sam(even), mesh, ParallelConfig(model_parallel=2))


def test_model_size_1_is_the_unsharded_encoder(setup, two):
    """In one process and on a (2 x 1) mesh of 2 ranks: the input itself,
    so the encode is bit-equal."""
    path, images = setup[:2]
    sam = _sam(path)
    mesh = meshlib.make_mesh(ParallelConfig())
    assert mesh.model_group is None and mesh.model_size == 1 and mesh.model_index == 0
    assert meshlib.shard_sam_params_tp(sam, mesh, ParallelConfig()) is sam
    assert [(r["shape"], r["model_size"], r["same_object"], r["bitequal"]) for r in two[0]] \
        == [((2, 1), 1, True, True)] * 2


# ------------------------------------------------------------------ encodes

def test_tp_encode_1x2_matches_unsharded_and_jax(setup, two):
    jax_out = setup[3]
    ranks = two[1]
    assert [r["cell"] for r in ranks] == [(0, 0), (0, 1)]
    assert all(r["model_group"] == [0, 1] and r["shape"] == (1, 2) for r in ranks)
    want = ranks[0]["want"]
    for r in ranks:
        assert r["got"].shape == (16, 16, 256) and np.isfinite(r["got"]).all()
        np.testing.assert_allclose(r["got"], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["got"], jax_out[0], rtol=TOL, atol=TOL)
    # the all-reduce hands both ranks the same sums
    np.testing.assert_array_equal(ranks[0]["got"], ranks[1]["got"])


def test_tp_encode_2x2_each_model_group_encodes_its_image(setup, four):
    """JAX's make_mesh layout: rank r at (r // 2, r % 2); the model groups
    are the grid's rows, the data groups its columns."""
    jax_out = setup[3]
    assert [r["cell"] for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["model_group"] for r in four] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [r["data_group"] for r in four] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    for r in four:
        d = r["cell"][0]
        want = four[2 * d]["want"]
        np.testing.assert_allclose(r["got"], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["got"], jax_out[d], rtol=TOL, atol=TOL)
    assert np.abs(four[0]["got"] - four[2]["got"]).max() > 0.01   # two images, two results
