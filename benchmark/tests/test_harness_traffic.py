"""The traffic files and the general generator: deterministic from the
seed, every seed the same sizes, DAVIS-like lengths and object counts in
their ranges."""

import numpy as np
import pytest

import tiny  # noqa: F401  (paths)
from harness import registry
from traffic import frames as F
from traffic import generate, schedule

BIG = 2**33 + 12345


def test_davis_pool_ranges_and_proportions():
    spec = registry.traffic("davis_videos")
    lengths = [n for n, _ in spec["videos"]]
    objs = [o for _, o in spec["videos"]]
    assert all(25 <= n <= 104 for n in lengths)
    assert all(1 <= o <= 5 for o in objs)
    share = {k: objs.count(k) / len(objs) for k in range(1, 6)}
    for k, want in zip(range(1, 6), (0.45, 0.25, 0.20, 0.05, 0.05)):
        assert abs(share[k] - want) <= 0.05
    assert 1.9 <= np.mean(objs) <= 2.1
    assert 60 <= np.mean(lengths) <= 70


@pytest.mark.parametrize("kind", ["videos", "stream", "clicks"])
def test_same_seed_same_inputs(kind):
    spec = tiny.traffic({"videos": "davis_videos", "stream": "long_video",
                         "clicks": "click_sessions"}[kind])
    gen = {"videos": lambda s: generate.videos(spec, s),
           "stream": lambda s: generate.stream(spec, s),
           "clicks": lambda s: generate.clicks(spec, s, 20)}[kind]
    a, b, c = gen(BIG), gen(BIG), gen(BIG + 1)

    def arrays(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in arrays(x[k])]
        if isinstance(x, list):
            return [v for e in x for v in arrays(e)]
        return [np.asarray(x)] if isinstance(x, np.ndarray) else [np.asarray(x)]

    for u, v in zip(arrays(a), arrays(b)):
        np.testing.assert_array_equal(u, v)
    assert any(u.shape == v.shape and not np.array_equal(u, v)
               for u, v in zip(arrays(a), arrays(c)))
    # every seed the same sizes: the same shapes, or for clicks the same
    # session lengths in another order
    if kind == "clicks":
        assert sorted(len(x["labels"]) for x in a["sessions"]) == sorted(
            len(x["labels"]) for x in c["sessions"])
    else:
        assert [u.shape for u in arrays(a)] == [v.shape for v in arrays(c)]


def test_videos_follow_the_file():
    spec = tiny.traffic("davis_videos")
    vids = generate.videos(spec, BIG)
    assert [(len(v["frames"]), v["objects"]) for v in vids] == [tuple(x) for x in spec["videos"]]
    for v in vids:
        assert sorted(np.unique(v["annotation"]).tolist()) == list(range(v["objects"] + 1))


def test_click_sessions_blocks_and_labels():
    spec = tiny.traffic("click_sessions")
    data = generate.clicks(spec, BIG, 40)
    lengths = [len(s["labels"]) for s in data["sessions"]]
    for i in range(0, 40, 5):
        assert sorted(lengths[i:i + 5]) == spec["session_clicks"]
    for s in data["sessions"]:
        assert s["labels"][0] == 1
        assert s["points"].shape == (len(s["labels"]), 2)
    assert any((s["labels"] == 0).any() for s in data["sessions"])


def test_pingpong_is_continuous():
    seq = [generate.pingpong(t, 4) for t in range(10)]
    assert seq == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]


def test_frozen_generators_equal_the_port_bench():
    from vosesam_tpu_torch import bench

    np.testing.assert_array_equal(F.multi_object_frames(3, 96, 128, 2, seed=7),
                                  bench.multi_object_frames(3, 96, 128, 2, seed=7))
    np.testing.assert_array_equal(F.soak_frames(3, 96, 128, seed=7), bench.soak_frames(3, 96, 128, seed=7))
    np.testing.assert_array_equal(F.moving_frames(3, 480, 854, seed=7), bench.moving_frames(3, 480, 854, seed=7))
    np.testing.assert_array_equal(F.multi_object_seed_mask(96, 128, 2, 3),
                                  bench.multi_object_seed_mask(96, 128, 2, 3))


def test_schedule_reaches_eviction_in_the_long_video_setup():
    cfg = registry.config(registry.benchmark(), "xmem-s012")
    spec = registry.traffic("long_video")
    s = schedule.memory_schedule(1 + spec["prefill_frames"], spec["height"], spec["width"],
                                 cfg["memory"])
    assert s == {"adds": 52, "consolidations": 9, "eviction_cycles": 2, "lt_valid": 1000,
                 "work_count": 52 * 1620 - 9 * 8100}
    assert [t for t in range(120) if schedule.consolidates_at(t, cfg["memory"])] == [45, 70, 95]
