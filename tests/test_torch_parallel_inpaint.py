"""`Inpainter(mesh=...)` (`parallel/inpaint_shard.py`): static inpaint windows
data-parallel over 2 gloo ranks on the CPU, against the port's unsharded
static path and the JAX package's mesh inpaint on 2 devices, with the same
weights (the JAX `generator_init`, carried across by `params_from_jax`).

13 frames at 60 x 108 make the static regime with anchors 0, 5 and 10: with
`window_batch=1` a group of two windows (one per rank) and a tail group of
one, padded with its last plan; with `window_batch=2` one group of four
slots (three windows and a pad), two windows per rank.

Tolerances: against the unsharded static path, computed in the same
process settings, equal (each rank runs the same unbatched generator on the
same windows; `window_batch=2` is held against the unsharded one-window
path, the sharded lanes being unbatched too). Against JAX: equal outside
the dilated mask; inside it >= 98% of the values within 2 grey levels
(ROADMAP C19: rounding noise flips a warp's floor() and is amplified
through the propagation under random weights; test_torch_inpaint.py holds
the same share).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import (
    FrameworkConfig,
    InpainterConfig,
    ParallelConfig,
    RefinementConfig,
)
from vosesam_tpu_torch.models.e2fgvi import generator as TG
from vosesam_tpu_torch.ops import morphology as morph
from vosesam_tpu_torch.parallel import mesh as meshlib
from vosesam_tpu_torch.pipeline import inpaint as tinp
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

RANKS = 2
T = 13
RADIUS = 2
TCFG = InpainterConfig(num_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side (and this file
    spawns ranks): keep this process's torch work from taking every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _video(t=T, hw=(60, 108), seed=4):
    r = np.random.default_rng(seed)
    frames = [r.integers(0, 255, hw + (3,), dtype=np.uint8) for _ in range(t)]
    masks = []
    for i in range(t):
        m = np.zeros(hw, np.uint8)
        m[20 + i % 3:35, 40:70 + i % 4] = 1
        masks.append(m)
    return frames, masks


def _net(path: str) -> TG.InpaintGenerator:
    net = TG.InpaintGenerator(TCFG)
    net.load_state_dict(torch.load(path, weights_only=True), strict=True)
    return net.eval()


def _ranks_body(weights_path: str):
    """One rank's work (spawned): the mesh inpaint at window_batch 1 and 2,
    the facade's `inpaint_mesh`; rank 0 also runs the unsharded path."""
    net = _net(weights_path)
    frames, masks = _video()
    mesh = meshlib.make_mesh(ParallelConfig())
    res = {"rank": mesh.rank}
    for wb in (1, 2):
        drv = tinp.Inpainter(cfg=dataclasses.replace(TCFG, window_batch=wb), net=net,
                             mesh=mesh, device="cpu")
        res[f"groups wb={wb}"] = [len(g) for g in drv._windows(T)]
        res[f"mesh wb={wb}"] = drv.inpaint_efficient(frames, masks, dilate_radius=RADIUS)
    if mesh.rank == 0:
        res["unsharded"] = tinp.Inpainter(cfg=TCFG, net=net, device="cpu").inpaint_efficient(
            frames, masks, dilate_radius=RADIUS)
    ta = TrackingAnything(cfg=FrameworkConfig(refinement=RefinementConfig(use_refinement=False),
                                              inpainter=TCFG),
                          e2fgvi_checkpoint="random", inpaint_mesh=mesh, device="cpu")
    res["facade mesh"] = ta.baseinpainter.mesh is mesh
    return res


@pytest.fixture(scope="module")
def jparams():
    import jax

    from vosesam_tpu.config import InpainterConfig as JInpainterConfig
    from vosesam_tpu.models.e2fgvi import generator as JG

    return JG.generator_init(jax.random.PRNGKey(0), JInpainterConfig(num_blocks=1))


@pytest.fixture(scope="module")
def ranks(jparams, tmp_path_factory):
    import jax

    from vosesam_tpu_torch.utils.checkpoint import params_from_jax

    path = str(tmp_path_factory.mktemp("e2fgvi") / "generator.pth")
    torch.save(params_from_jax(jax.tree.map(np.asarray, jparams)), path)
    return meshlib.run_ranks(_ranks_body, RANKS, path, device="cpu", timeout_s=300, threads=2)


def _dilated(masks):
    return morph.dilate(torch.from_numpy(np.stack([x > 0 for x in masks])), RADIUS).numpy()


def test_windows_group_by_data_size_times_window_batch(ranks):
    for r in ranks:
        assert r["groups wb=1"] == [2, 1] and r["groups wb=2"] == [3]
        assert r["facade mesh"]


def test_every_rank_composites_the_same_video(ranks):
    for key in ("mesh wb=1", "mesh wb=2"):
        for a, b in zip(ranks[0][key], ranks[1][key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wb", [1, 2])
def test_mesh_inpaint_equals_the_unsharded_static_path(ranks, wb):
    got, want = ranks[0][f"mesh wb={wb}"], ranks[0]["unsharded"]
    assert len(got) == len(want) == T
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


def test_mesh_inpaint_matches_jax_mesh_inpaint(ranks, jparams):
    import jax
    from jax.sharding import Mesh

    from tests.test_torch_e2fgvi import published_roundings
    from vosesam_tpu.config import InpainterConfig as JInpainterConfig
    from vosesam_tpu.pipeline import inpaint as jinp

    mesh = Mesh(np.asarray(jax.devices()[:RANKS]).reshape(RANKS, 1), ("data", "model"))
    frames, masks = _video()
    with published_roundings():         # the roundings the port follows
        want = jinp.Inpainter(cfg=JInpainterConfig(num_blocks=1), params=jparams,
                              mesh=mesh).inpaint_efficient(frames, masks, dilate_radius=RADIUS)
    got = ranks[0]["mesh wb=1"]
    dil = _dilated(masks)
    inside = []
    for i in range(T):
        np.testing.assert_array_equal(got[i][~dil[i]], frames[i][~dil[i]])
        np.testing.assert_array_equal(got[i][~dil[i]], want[i][~dil[i]])
        inside.append(np.abs(got[i].astype(np.int32) - want[i].astype(np.int32))[dil[i]])
    inside = np.concatenate(inside)
    assert inside.size > 0 and float((inside <= 2).mean()) >= 0.98, float((inside <= 2).mean())


def test_a_mesh_must_be_a_parallel_mesh():
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tinp.Inpainter(cfg=TCFG, mesh=object(), device="cpu")
