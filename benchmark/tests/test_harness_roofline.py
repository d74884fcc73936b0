"""The yardstick: counts against hand counts at small shapes, and the
frozen `encode_flops` against the port bench's."""

import math

import pytest
import torch

import tiny  # noqa: F401
from roofline import attention, encode, memory_read, peaks
from roofline.step import StepFlops


@pytest.mark.parametrize("grid", [(64, 64), (36, 64)])
def test_encode_flops_equals_the_port_bench(grid):
    from vosesam_tpu_torch import bench
    from vosesam_tpu_torch.config import SAMConfig

    scfg = SAMConfig(model_type="vit_h", hq=True)
    dim, depth, heads, glb = scfg.encoder_dims()
    ours = encode.encode_flops(dim, depth, heads, glb, scfg.window_size, scfg.patch_size,
                               scfg.windowed_attention_impl, grid)
    assert ours == bench.encode_flops(scfg, grid)


def test_encode_flops_by_hand_one_global_block():
    # dim 4, 1 head, one global block on a 2x2 grid, patch 1, window 2
    f = encode.encode_flops(4, 1, 1, (0,), 2, 1, "xla", (2, 2))
    n, d = 4, 4
    want = (2 * n * d * 3                       # patch embed (3 channels, 1x1 patch)
            + 2 * n * d * 4 * d + 2 * n * d * 8 * d     # qkv + proj, MLP
            + 2 * n * d * (2 + 2)               # rel-pos factors
            + 2 * n * n * d * 2                 # qk^T and pv
            + 2 * n * d * 256 + 2 * n * 256 * 256 * 9)  # neck
    assert f == want


def test_memory_read_by_hand():
    f, b = memory_read.read_work(q=3, m=5, ck=2, cv=4, objects=2, top_k=30, itemsize=2)
    assert f == 4 * 3 * 5 * 2 + 2 * 2 * 3 * 5 * 4      # top-k clipped to m
    assert b == 2 * (5 * 2 + 5 + 2 * 5 * 4 + 2 * 3 * 2 + 2 * 3 * 4)


def test_global_attention_by_hand_and_against_attn_bound():
    f, b = attention.global_attention_work(b=1, heads=2, gh=2, gw=3, d=4, itemsize=2)
    n = 6
    assert f == 4 * 2 * n * n * 4 + 2 * 2 * n * 5 * 4
    assert b == 4 * 2 * n * 4 * 2
    ms, what = attention.attn_bound(2, 2, 3, 4, 2, 1e12, 1e9)
    assert what == "bytes" and math.isclose(ms, (4 * 2 * n * 4 * 2 + 2 * n * 5 * 4) / 1e9 * 1e3)


def test_step_counts_match_hand_counts_of_the_plain_modules():
    cfg = tiny.config("xmem-s012_samhq-vith")
    st = StepFlops(cfg)
    assert st.read(10, 20, 2) == memory_read.read_work(10, 20, 64, 512, 2, 8, 2)[0]
    # the key encoder's first convolution alone, by hand, is part of its count
    stem = 2 * (64 // 2) * (96 // 2) * 64 * 3 * 49
    assert st.xmem(64, 96, 1, False) > stem
    assert st.xmem(64, 96, 2, True) > st.xmem(64, 96, 2, False) > st.xmem(64, 96, 1, False)
    # the packs' decodes scale with packs; the HQ features' compression with frames
    one, three = st.decode(1, 5, (8, 8), False), st.decode(3, 5, (8, 8), False)
    assert one < three < 3 * one
    assert st.decode(3, 5, (8, 8), False, frames=3) == pytest.approx(3 * one, rel=1e-3)
    assert st.encode((8, 8)) == encode.encode_flops(64, 2, 2, (1,), 7, 16, "xla", (8, 8))


def test_peaks_of_the_card():
    p = peaks.for_card("NVIDIA H100 80GB HBM3")
    assert p["bf16_dense_flops_per_s"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert peaks.for_card("cpu") is None
