"""The port's bench rows beyond the headline (`vosesam_tpu_torch/bench.py`),
on the CPU:

  - the synthetic video families (`tri`, `multi_object_frames`,
    `multi_object_seed_mask`, `soak_frames`) bit-equal to the root bench's,
    which are numpy only;
  - the sensitivity rows through `run(sensitivity=True)` at a tiny size
    (the TINY SAM and small memory of `tests/test_torch_profiling.py`,
    48x64 frames): the letterbox row measures the headline's loop at the
    root bench's transform of the config (`encode_letterbox_hw=(448,
    896)`), the object-count rows at O 1, 2, 4 and 8 with the object axis,
    the live-object hint and the seed sized to O, the read corridor and a
    short soak, every key of the line present and positive;
  - the read corridor at a small (Q, M) through the plain version: the
    wrapper called at live_end = M, M / 2 and M / 4, finite times, no
    device time off the card;
  - a soak past the fps windows (256 frames at chunk 2, the one-object
    family): the frame_64 window of three runs, the fresh-state control,
    the schedule held against the probes;
  - a soak whose memory accounting is broken (a monkeypatched
    consolidation that keeps one frame too few, or that never marks a
    long-term slot valid) raises.
The soak against the JAX package's `_soak` is tests/test_torch_bench_soak.py.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import bench as root
from vosesam_tpu_torch import bench
from vosesam_tpu_torch.config import (
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.memory import manager
from vosesam_tpu_torch.ops.kernels import memory_read as mr

H, W = 48, 64
TINY_SAM = dict(model_type="vit_b", image_size=128, window_size=7,
                vit_dims=(("vit_b", 64, 2, 2, (1,)),), hq=True, encode_rect=True)
SMALL_MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
                 num_prototypes=8, top_k=8, mem_every=2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------- the video families

@pytest.mark.parametrize("t,amp", [(0, 60), (7, 60), (59, 60), (60, 60), (61, 60),
                                   (119, 60), (120, 60), (1000, 40), (941, 470)])
def test_tri_matches_the_root_bench(t, amp):
    assert bench.tri(t, amp) == root.tri(t, amp)


@pytest.mark.parametrize("o", [1, 2, 4, 8])
@pytest.mark.parametrize("hw", [(480, 854), (48, 64)])
def test_multi_object_frames_bit_equal(o, hw):
    h, w = hw
    np.testing.assert_array_equal(bench.multi_object_frames(5, h, w, o, seed=3),
                                  root.multi_object_frames(5, h, w, o, seed=3))
    for max_objects in (o, 8):
        np.testing.assert_array_equal(bench.multi_object_seed_mask(h, w, o, max_objects),
                                      root.multi_object_seed_mask(h, w, o, max_objects))


def test_multi_object_seed_mask_covers_frame_zero():
    frames = bench.multi_object_frames(1, 480, 854, 8)
    seed = bench.multi_object_seed_mask(480, 854, 8, 8)
    for k in range(8):
        assert (frames[0][seed[k] > 0] == bench._OBJ_COLORS[k]).all()
    with pytest.raises(ValueError):
        bench.multi_object_frames(1, 480, 854, 9)


@pytest.mark.parametrize("hw,n", [((480, 854), 3), ((48, 64), 4)])
def test_soak_frames_bit_equal(hw, n):
    np.testing.assert_array_equal(bench.soak_frames(n, *hw), root.soak_frames(n, *hw))


def test_soak_frames_stay_in_frame_over_a_long_rollout():
    """Periodic motion: the objects' frame-0 boxes recur (the soak's
    seed masks are theirs)."""
    frames = bench.soak_frames(1, 480, 854)
    seed = bench.soak_seed_mask(480, 854, 2)
    assert (frames[0][seed[0] > 0] == (220, 60, 60)).all()
    assert (frames[0][seed[1] > 0] == (60, 200, 220)).all()
    for i in (190, 700, 1535):
        y0, x0 = 40 + bench.tri(2 * i, 180), 10 + bench.tri(5 * i, 470)
        assert y0 + 220 <= 480 and x0 + 350 <= 854


def test_new_knobs_have_the_root_defaults():
    k = bench.knobs({})
    assert (k["BENCH_EXTRAS"], k["BENCH_OBJECTS"], k["BENCH_SOAK"],
            k["BENCH_SOAK_FRAMES"]) == ("1", "1", "1", "1536")
    cfg = bench.make_cfg(k)
    assert cfg.sam.encode_fixed_hw is None and cfg.sam.encode_letterbox_hw is None
    fixed = bench.make_cfg(bench.knobs({"BENCH_FIXED_HW": "448x896"}))
    assert fixed.sam.encode_fixed_hw == (448, 896)
    lb = bench.make_cfg(bench.knobs({"BENCH_LETTERBOX_HW": "448x896"}))
    assert lb.sam.encode_letterbox_hw == (448, 896) and lb.sam.encode_fixed_hw is None
    assert bench.LETTERBOX_HW == (448, 896)


# ------------------------------------------------------ the sensitivity rows

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


def tiny_cfg():
    return FrameworkConfig(xmem=XMemConfig(max_objects=2, key_dim=16, value_dim=24,
                                           hidden_dim=8),
                           memory=MemoryConfig(live_objects=2, **SMALL_MEM),
                           sam=SAMConfig(**TINY_SAM),
                           refinement=RefinementConfig(mode="both_neg", optimized=True),
                           dtype="float32")


def test_sensitivity_rows_through_run(monkeypatch):
    calls = []
    real = bench.measure

    def spy(cfg, frames, seed, chunk, n_frames, stages, reps, dev, n_live=None):
        calls.append(dict(cfg=cfg, frames=frames, seed=seed, n_frames=n_frames,
                          n_live=n_live))
        return real(cfg, frames, seed, chunk, n_frames, stages, reps, dev, n_live)

    monkeypatch.setattr(bench, "measure", spy)
    # the corridor at a small (Q, M): its production shape is slow on the CPU
    monkeypatch.setattr(bench, "read_occupancy_corridor", functools.partial(
        bench.read_occupancy_corridor, q=40, m=300))
    cfg = tiny_cfg()
    # 16 soak frames: 9 memory frames, 7 consolidations, no eviction due yet
    env = dict(bench.DEFAULTS, BENCH_FRAMES="4", BENCH_CHUNK="2", BENCH_REPS="1",
               BENCH_STAGES="0", BENCH_INPAINT="0", BENCH_INTERACTIVE="0",
               BENCH_SOAK_FRAMES="16")
    line = bench.run(env, device="cpu", cfg=cfg, frames_fn=tiny_frames, seed=tiny_seed(),
                     sensitivity=True, objects_frames=2)
    parsed = json.loads(json.dumps(line))
    assert parsed["value"] > 0 and parsed["device"] == "cpu"

    # the headline, the letterbox row (the same frames and seed, the root
    # bench's transform of the config), then one row per object count
    head, lb, *objs = calls
    assert head["cfg"] == cfg
    assert lb["cfg"] == dataclasses.replace(
        cfg, sam=dataclasses.replace(cfg.sam, encode_letterbox_hw=(448, 896)))
    assert lb["frames"] is head["frames"] and lb["seed"] is head["seed"]
    assert parsed["letterbox_fps"] > 0 and len(parsed["letterbox_fps_runs"]) == 1
    assert parsed["letterbox_fps"] == parsed["letterbox_fps_runs"][0]
    assert "letterbox_vs_baseline" not in parsed

    assert [c["cfg"].xmem.max_objects for c in objs] == [1, 2, 4, 8]
    for c in objs:
        o = c["cfg"].xmem.max_objects
        assert c["cfg"].memory.live_objects == o and c["n_live"] == o
        assert c["cfg"].sam == cfg.sam and c["n_frames"] == 2
        np.testing.assert_array_equal(c["seed"], bench.multi_object_seed_mask(H, W, o, o))
        np.testing.assert_array_equal(c["frames"], bench.multi_object_frames(5, H, W, o))
    assert set(parsed["fps_by_objects"]) == {"1", "2", "4", "8"}
    assert all(v > 0 for v in parsed["fps_by_objects"].values())

    assert set(parsed["read_ms_at_occupancy"]) == {"live_1", "live_0.5", "live_0.25"}
    assert all(v > 0 for v in parsed["read_ms_at_occupancy"].values())
    assert parsed["read_device_ms_at_occupancy"] is None        # no card

    soak = parsed["soak"]
    assert soak["frames"] == 16 and soak["consolidations"] == 7
    assert soak["lt_eviction_cycles"] == 0 and soak["lt_valid_final"] == 56
    assert soak["fps_windows"] == {} and soak["fps_fresh_control"] is None
    assert soak["peak_device_bytes"] is None and 0 <= soak["mask_area_final"] <= 1


@pytest.mark.parametrize("knob", ["BENCH_EXTRAS", "BENCH_FIXED_HW", "BENCH_LETTERBOX_HW"])
def test_sensitivity_rows_run_where_the_root_runs_them(knob, monkeypatch):
    """Off with BENCH_EXTRAS=0 or another encode gear, as the root bench's
    condition reads; the soak has its own knob."""
    ran = []
    monkeypatch.setattr(bench, "measure", lambda *a, **k: ran.append(a[0]) or ([1.0], 1, {}))
    monkeypatch.setattr(bench, "read_occupancy_corridor", lambda *a, **k: ran.append("c"))
    monkeypatch.setattr(bench, "soak", lambda *a, **k: ran.append("s") or {})
    env = dict(bench.DEFAULTS, BENCH_CHUNK="2", BENCH_INPAINT="0", BENCH_INTERACTIVE="0",
               **{knob: "0" if knob == "BENCH_EXTRAS" else "448x896"})
    cfg = dataclasses.replace(bench.make_cfg(bench.knobs(env)),
                              xmem=XMemConfig(max_objects=2, key_dim=16, value_dim=24,
                                              hidden_dim=8))
    line = bench.run(env, device="cpu", cfg=cfg, frames_fn=tiny_frames, seed=tiny_seed(),
                     sensitivity=True)
    assert len(ran) == (2 if knob == "BENCH_EXTRAS" else 1)    # the headline (+ soak)
    assert "letterbox_fps" not in line and "fps_by_objects" not in line
    assert ("soak" in line) == (knob == "BENCH_EXTRAS")


def test_read_corridor_on_the_cpu(monkeypatch):
    seen = []
    real = mr.fused_memory_read_shared

    def spy(*args, live_end=None, return_usage=False):
        seen.append((live_end, return_usage))
        return real(*args, live_end=live_end, return_usage=return_usage)

    monkeypatch.setattr(mr, "fused_memory_read_shared", spy)
    mr.reset_counts()
    wall, dev_ms = bench.read_occupancy_corridor("cpu", q=64, m=400, cv=32, calls=2)
    assert set(wall) == {"live_1", "live_0.5", "live_0.25"}
    assert all(np.isfinite(v) and v > 0 for v in wall.values())
    assert dev_ms is None
    assert sorted(set(seen)) == [(100, True), (200, True), (400, True)]
    assert mr.COUNTS["plain"] == 9 and mr.COUNTS["fused_memory_read_shared"] == 0


# ------------------------------------------------------------------ the soak

def _soak_cfg():
    return FrameworkConfig(xmem=XMemConfig(max_objects=2, key_dim=16, value_dim=24,
                                           hidden_dim=8),
                           memory=MemoryConfig(**SMALL_MEM),
                           refinement=RefinementConfig(use_refinement=False), dtype="float32")


def test_soak_windows_and_fresh_control():
    out = bench.soak(_soak_cfg(), H, W, 2, 256, objects=1, device="cpu")
    # windows at frames 56 (frame_64: 3 x 64 frames), 448 (past the end)
    # and the tail (256 - 192 = 64: overlaps frame_64)
    assert set(out["fps_windows"]) == {"frame_64"}
    runs = out["fps_window_runs"]["frame_64"]
    assert len(runs) == 3 and out["fps_windows"]["frame_64"] == sorted(runs)[1]
    assert out["fps_fresh_control"] > 0
    assert (out["frames"], out["consolidations"], out["lt_eviction_cycles"],
            out["lt_valid_final"]) == (256, 127, 119, 64)
    assert out["lt_overwrites_observed"] > 0
    assert json.loads(json.dumps(out)) == out



def _keep_one_frame_too_few(real):
    def broken(state, cfg, hw):
        state = real(state, cfg, hw)
        state.work.count -= hw
        return state
    return broken


def _never_valid(real):
    def broken(state, cfg, hw):
        state = real(state, cfg, hw)
        state.long.key_valid[:] = False
        return state
    return broken


@pytest.mark.parametrize("break_it,message", [
    (_keep_one_frame_too_few, "arena accounting broke"),
    (_never_valid, "never saturated"),
])
def test_soak_with_a_broken_consolidation_raises(break_it, message, monkeypatch):
    monkeypatch.setattr(manager, "_consolidate", break_it(manager._consolidate))
    with pytest.raises(RuntimeError, match=message):
        bench.soak(_soak_cfg(), H, W, 2, 32, objects=1, device="cpu")
