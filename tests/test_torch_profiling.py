"""The port's profiling module (`vosesam_tpu_torch/utils/profiling.py`)
against its JAX twin (`vosesam_tpu/utils/profiling.py`), and the port's
bench (`python -m vosesam_tpu_torch.bench`) on the CPU:

  - `StageTimer`'s summary, report and JSON carry the twin's keys and units
    (ms per entry) for the same stages;
  - `trace` writes a Chrome trace; `device_memory_stats` is None on the
    CPU; `sync` finds the last tensor of a tree;
  - `bench.encode_flops`, the analytic FLOP count of one frame's encode,
    equals what `torch.utils.flop_counter.FlopCounterMode` counts over the
    plain CPU encode (vit_b at 256, flash off) within 1% (both count the
    products only: the patch embed and neck convolutions, the linear
    layers, the rel-pos factor einsums and the attention matmuls);
  - the bench's rows end to end at a tiny size with `device="cpu"` (TINY
    SAM of `tests/test_pipeline.py`, a small memory so that long-term
    consolidation fires, 48x64 frames, a 60x108 inpaint window): the line
    is one JSON object with the root bench's keys and the extras.
"""

import json
import time

import numpy as np
import pytest
import torch

from vosesam_tpu_torch import bench
from vosesam_tpu_torch.config import (
    FrameworkConfig,
    InpainterConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.models.sam import image_encoder as tenc
from vosesam_tpu_torch.utils import profiling as tprof


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side: keep this
    process's torch work from taking every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ the timers

def _timed(mod, result):
    timer = mod.StageTimer()
    for _ in range(2):
        with timer.stage("encode"):
            time.sleep(0.002)
            timer.record(result)
        with timer.stage("xmem"):
            time.sleep(0.001)
    off = mod.StageTimer(enabled=False)
    with off.stage("encode"):
        pass
    return timer, off


def test_stage_timer_matches_the_jax_twin(tmp_path):
    import jax.numpy as jnp

    from vosesam_tpu.utils import profiling as jprof

    jt, joff = _timed(jprof, {"a": jnp.ones(3)})
    tt, toff = _timed(tprof, {"a": (torch.ones(3), torch.zeros(2))})
    assert set(tt.summary()) == set(jt.summary()) == {"encode", "xmem"}
    assert dict(tt.counts) == dict(jt.counts) == {"encode": 2, "xmem": 2}
    assert toff.summary() == joff.summary() == {}
    for timer in (tt, jt):           # ms per entry: 2 ms and 1 ms sleeps
        s = timer.summary()
        assert 2.0 <= s["encode"] < 200 and 1.0 <= s["xmem"] < 200
    shape = lambda rep: [(ln.split(":")[0], ln.split()[-1]) for ln in rep.splitlines()]  # noqa: E731
    assert shape(tt.report()) == shape(jt.report())
    assert tt.report().splitlines()[-1].strip().startswith("TOTAL:")
    tt.dump_json(str(tmp_path / "t.json"))
    jt.dump_json(str(tmp_path / "j.json"))
    t, j = (json.loads((tmp_path / n).read_text()) for n in ("t.json", "j.json"))
    assert set(t) == set(j) and all(isinstance(v, float) for v in t.values())


def test_sync_finds_the_last_tensor_of_a_tree():
    from vosesam_tpu_torch.inference.refinement import RefinementResult

    t = torch.ones(2)
    assert tprof._last_tensor({"a": t, "b": [1, (None, t[:1])]}) is not None
    assert tprof._last_tensor([t, "x", None]) is t
    res = RefinementResult(t, t, t[:1], t)
    assert tprof._last_tensor(res) is res.used_sam
    assert tprof._last_tensor({"a": 1}) is None
    tprof.sync({"a": t})           # CPU tensors are ready: nothing to wait for
    tprof.sync(None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    out = tmp_path / "tr" / "trace.json"
    assert out.stat().st_size > 0
    assert "traceEvents" in json.loads(out.read_text())


def test_device_memory_stats_is_none_on_the_cpu():
    assert not torch.cuda.is_available()
    assert tprof.device_memory_stats() is None


# ------------------------------------------------------ the FLOP count

@pytest.mark.parametrize("impl,size,hw,grid", [
    ("xla", 256, (256, 256), (16, 16)), ("xla_fused_bias", 256, (256, 256), (16, 16)),
    ("xla_fused_bias", 256, (128, 256), (8, 16)), ("xla_fused_bias", 224, (200, 224), (13, 14))])
def test_encode_flops_matches_the_flop_counter(impl, size, hw, grid):
    """vit_b, flash off, the rect encode. (128, 256) is a grid of 8x16
    tokens (two windows a frame); at image size 224 a frame is one 14x14
    window, which takes the "xla" path whatever the impl: no bias lanes."""
    from torch.utils.flop_counter import FlopCounterMode

    from vosesam_tpu_torch.models.sam.predictor import preprocess

    cfg = SAMConfig(model_type="vit_b", image_size=size, use_flash_attention=False,
                    windowed_attention_impl=impl, encode_rect=True)
    enc = tenc.ImageEncoderViT(cfg).eval()
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 255, hw + (3,), np.uint8))
    x, _ = preprocess(img[None], cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        y = tenc.vit_encode(enc, x)
    counted = fc.get_total_flops()
    want = bench.encode_flops(cfg, tuple(y.shape[1:3]))
    assert tuple(y.shape[1:3]) == grid
    assert abs(want - counted) <= 0.01 * counted, (want, counted)


# ------------------------------------------------------------- the bench

H, W = 48, 64
TINY_SAM = dict(model_type="vit_b", image_size=128, window_size=7,
                vit_dims=(("vit_b", 64, 2, 2, (1,)),), hq=True, encode_rect=True)
SMALL_MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
                 num_prototypes=8, top_k=8, mem_every=2, live_objects=2)


def tiny_frames(n):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (H, W, 3), np.uint8)
    out = np.repeat(base[None], n, 0)
    for i in range(n):
        out[i, 6 + i % 8:20 + i % 8, 4 + i % 10:24 + i % 10] = (220, 60, 60)
        out[i, 28:42, 40 - i % 6:60 - i % 6] = (60, 200, 220)
    return out


def tiny_seed():
    m = np.zeros((2, H, W), np.float32)
    m[0, 6:20, 4:24] = 1.0
    m[1, 28:42, 40:60] = 1.0
    return m


def test_bench_line_at_a_tiny_size_on_the_cpu():
    cfg = FrameworkConfig(xmem=XMemConfig(max_objects=2, key_dim=16, value_dim=24,
                                          hidden_dim=8),
                          memory=MemoryConfig(**SMALL_MEM), sam=SAMConfig(**TINY_SAM),
                          refinement=RefinementConfig(mode="both_neg", optimized=True),
                          dtype="float32")
    env = dict(bench.DEFAULTS, BENCH_FRAMES="6", BENCH_CHUNK="2", BENCH_REPS="2")
    line = bench.run(env, device="cpu", cfg=cfg, frames_fn=tiny_frames, seed=tiny_seed(),
                     inpaint=dict(cfg=InpainterConfig(num_blocks=1), t=5, nl=3, h=60, w=108,
                                  reps=1),
                     interactive_n=3)
    parsed = json.loads(json.dumps(line))
    assert parsed["unit"] == "fps" and parsed["value"] > 0
    assert parsed["metric"].startswith(f"DAVIS {H}x{W} frames/sec/card (XMem+SAM-HQ vit_b")
    assert len(parsed["fps_runs"]) == 2 and parsed["fps_median"] == parsed["value"]
    assert parsed["lt_count"] > 0
    stages = parsed["stage_ms_per_frame"]
    assert set(stages) == {"encode", "xmem", "encode_refine", "total"}
    assert all(v > 0 for v in stages.values())
    assert parsed["encode_grid"] == [6, 8]     # 48x64 -> 96x128 at image size 128
    assert parsed["encode_tflops"] > 0
    assert "mfu_vs_peak" not in parsed          # no bf16 peak is known for the CPU
    assert set(parsed["interactive_ms"]) == {
        f"{k}_ms_{q}" for k in ("set_image", "click_to_mask", "track_frame")
        for q in ("p50", "p95")}
    assert parsed["inpaint_ms_per_window"] > 0
    assert parsed["inpaint_ms_per_output_frame"] == pytest.approx(
        parsed["inpaint_ms_per_window"] / InpainterConfig().neighbor_stride)
    assert parsed["peak_memory_bytes"] is None and parsed["device"] == "cpu"


def test_bench_defaults_are_the_root_benchs():
    cfg = bench.make_cfg(bench.knobs({}))
    assert (cfg.sam.model_type, cfg.sam.hq, cfg.sam.encode_rect, cfg.sam.use_flash_attention,
            cfg.sam.windowed_attention_impl) == ("vit_h", True, True, True, "xla_fused_bias")
    assert cfg.xmem.max_objects == 2 and cfg.memory.live_objects == 2
    assert cfg.refinement.use_refinement and cfg.refinement.mode == "both_neg"
    assert cfg.dtype == "bfloat16"
    assert bench.knobs({})["BENCH_FRAMES"] == "64" and bench.knobs({})["BENCH_REPS"] == "3"
    assert bench.make_cfg(bench.knobs({"BENCH_LIVE": "0"})).memory.live_objects is None
    frames = bench.moving_frames(3, 480, 854)
    seed = bench.seed_mask(480, 854, 2)
    # the seed covers the first frame's two objects
    assert (frames[0][seed[0] > 0] == (220, 60, 60)).all()
    assert (frames[0][seed[1] > 0] == (60, 200, 220)).all()


def test_bench_main_without_cuda_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()
