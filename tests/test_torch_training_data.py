"""The port's clip sampler (`vosesam_tpu_torch/training/data.py`) against
`vosesam_tpu.training.data` on the CPU: for one seed and one tree (the
port's synthetic DAVIS tree with PNG frames, read by each package's own
`DavisDataset`), the same clips bit for bit — frames, labels and validity —
through crops, flips, retries, the label subset and the jitter; plus the
batch contract, the curriculum hook and the errors.
"""

import numpy as np
import pytest

from vosesam_tpu.eval.datasets import DavisDataset as JDavisDataset
from vosesam_tpu.training.data import ClipSampler as JClipSampler
from vosesam_tpu.training.data import ClipSamplerConfig as JClipSamplerConfig
from vosesam_tpu_torch.eval.datasets import DavisDataset
from vosesam_tpu_torch.eval.synthetic import write_tree
from vosesam_tpu_torch.training.data import ClipSampler, ClipSamplerConfig


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("syn")
    write_tree(str(root), h=56, w=80, seed=3, davis_frames=9, long_frames=2, lvos_frames=1,
               ovis_frames=2)
    return str(root / "DAVIS")


def _pair(tree, seed, max_objects=3, **kw):
    j = JClipSampler(JDavisDataset(tree, imset="2017/val.txt"), JClipSamplerConfig(**kw),
                     max_objects, seed=seed)
    t = ClipSampler(DavisDataset(tree, imset="2017/val.txt"), ClipSamplerConfig(**kw),
                    max_objects, seed=seed)
    return j, t


@pytest.mark.parametrize("seed, max_objects, kw", [
    (0, 3, dict(seq_length=4, crop=32)),
    (1, 1, dict(seq_length=3, crop=24, min_scale=0.2, hflip_prob=0.9)),   # label subset
    (7, 2, dict(seq_length=8, crop=40, max_jump=2, min_scale=0.05)),       # walk back, retries
])
def test_clips_bit_equal_to_jax(tree, seed, max_objects, kw):
    j, t = _pair(tree, seed, max_objects, **kw)
    for _ in range(3):
        jf, jg, jv = j.sample_batch(2)
        tf, tg, tv = t.sample_batch(2)
        assert tf.dtype == jf.dtype and tg.dtype == jg.dtype == np.int32
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(tv, jv)
    # the generators drew the same numbers: the next draw agrees too
    assert t.rng.integers(0, 2 ** 31) == j.rng.integers(0, 2 ** 31)


def test_batch_contract_and_curriculum(tree):
    _, t = _pair(tree, 0, seq_length=3, crop=32)
    frames, gt, valid = t.sample_batch(2)
    assert frames.shape == (2, 3, 32, 32, 3) and gt.shape == (2, 3, 32, 32)
    assert valid.shape == (2, 3) and valid.dtype == bool
    assert gt.max() <= 3 and valid[:, 0].all()
    t.set_max_jump(1)
    assert t.cfg.max_jump == 1
    picks = t._pick_frames([f"{i:05d}.png" for i in range(9)])
    steps = np.diff([int(p[:5]) for p in picks])
    assert (steps == 1).all()


def test_no_annotated_video_raises(tree):
    class Empty:
        videos = ["a"]

        def video_info(self, v):
            return {"frames": ["00000.png", "00001.png"]}

        def load_mask(self, v, f):
            return None

    with pytest.raises(ValueError, match="annotated"):
        ClipSampler(Empty(), ClipSamplerConfig(), 2)
