"""The port's soak (`vosesam_tpu_torch.bench.soak`) against the root bench's
`_soak` (the JAX package), on the CPU at the tiny memory config of
`tests/test_soak_parallel.py` (48x64 frames: 12 tokens a frame, a working
memory of 3 frames that keeps 2, 64 long-term elements, 8 prototypes, a
memory frame every 2), refinement off, chunk 2, XMem-only at XMem-s012's
widths.

Held equal: the frames the soak ran, its analytic consolidation and
eviction counts, the saturated long-term count it probed and the
overwrites it saw between saturated probes (each package's own seeded
weights: none of these depends on them while the input moves).

The soak's two-object family is laid out for 480x854: at 48x64 its objects
leave the frame after ~11 frames, the input is then static and the
long-term arena cycles through the same contents with a period that
divides the probe stride (16 chunks). At 64 frames both packages then
raise the eviction-overwrite check although 23 eviction cycles fire (the
check compares the sum of |keys| at probes): the check's blind spot is the
JAX package's too, and held here. The one-object family keeps moving at
48x64 (its object's path is periodic inside the frame's top rows), and
there both packages see every overwrite the probes can show.
"""

import jax
import pytest
import torch

import bench as root
from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import RefinementConfig as JRefinementConfig
from vosesam_tpu.config import XMemConfig as JXMemConfig
from vosesam_tpu_torch import bench
from vosesam_tpu_torch.config import (
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    XMemConfig,
)

H, W, CHUNK = 48, 64, 2
MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
           num_prototypes=8, top_k=8, mem_every=2)
SAME_KEYS = ("frames", "consolidations", "lt_eviction_cycles", "lt_valid_final",
             "lt_overwrites_observed")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _cfgs():
    j = JFrameworkConfig(xmem=JXMemConfig(max_objects=2), memory=JMemoryConfig(**MEM),
                         refinement=JRefinementConfig(use_refinement=False), dtype="float32")
    t = FrameworkConfig(xmem=XMemConfig(max_objects=2), memory=MemoryConfig(**MEM),
                        refinement=RefinementConfig(use_refinement=False), dtype="float32")
    return j, t


@pytest.mark.parametrize("n_frames,counts", [(64, (31, 23, 64, 1)), (96, (47, 39, 64, 2))])
def test_soak_matches_the_jax_soak(n_frames, counts):
    jcfg, tcfg = _cfgs()
    with jax.default_device(jax.devices("cpu")[0]):
        want = root._soak(jcfg, H, W, CHUNK, n_frames, objects=1)
    got = bench.soak(tcfg, H, W, CHUNK, n_frames, objects=1, device="cpu")
    assert {k: got[k] for k in SAME_KEYS} == {k: want[k] for k in SAME_KEYS}
    # n / 2 + 1 memory frames, 3 fill the working memory, then each
    # consolidates; 8 consolidations fill the long-term memory
    assert tuple(got[k] for k in SAME_KEYS[1:]) == counts
    # no fps window fits under 3 x 64 + 56 frames
    assert got["fps_windows"] == want["fps_windows"] == {}
    assert got["fps_fresh_control"] is None and want["fps_fresh_control"] is None


def test_soak_overwrite_check_blind_spot_is_shared():
    jcfg, tcfg = _cfgs()
    with pytest.raises(AssertionError, match="eviction-overwrite never observed despite 23"):
        with jax.default_device(jax.devices("cpu")[0]):
            root._soak(jcfg, H, W, CHUNK, 64)
    with pytest.raises(RuntimeError, match="eviction-overwrite never observed despite 23"):
        bench.soak(tcfg, H, W, CHUNK, 64, device="cpu")
