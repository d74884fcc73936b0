"""Data-parallel XMem training (`training/trainer.py:train_step(mesh=)`,
`train_xmem --dp`) on 2 gloo ranks on the CPU: each rank takes B / 2 clips,
the gradients (batch-norm statistics' leaves included) and losses are
all-reduced and halved, and both ranks apply the same AdamW update.

Held against the port's single step over all B clips and against JAX's
single-placement `train_step`, at the toy dims and batch of
test_torch_training.py (so the JAX compile is the one that file makes).

Tolerances: the first AdamW step moves an element by about lr x sign(g),
so an element whose near-zero gradient changes sign with the order of the
sums moves by up to 2 lr the other way; elsewhere the sign is certain and
the step agrees to rounding. So: every element within 2.5 lr (JAX's own DP
test's bound, tests/test_parallel.py) and at least 99.9% of all the
trained elements within 1e-6 of the single step (1e-5 of JAX's, the value
of test_torch_training.py, whose two frameworks differ more); the loss within
1e-5 relative of the single step (JAX's DP test's value) and 1e-4 of JAX's
(test_torch_training.py's). Both ranks end bit-equal.
"""

import os

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import FrameworkConfig, ParallelConfig, XMemConfig
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.parallel import mesh as meshlib
from vosesam_tpu_torch.training import trainer as T

RANKS = 2
DIMS = dict(key_dim=8, value_dim=16, hidden_dim=4, max_objects=2)
TCFG = FrameworkConfig(xmem=XMemConfig(**DIMS), dtype="float32")
LR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side (and this file
    spawns ranks): keep this process's torch work from taking every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _batch(b=2, t=3, hw=32, scale=0.01, seed=0):
    """test_torch_training.py's batch."""
    rng = np.random.default_rng(seed)
    frames = (scale * rng.normal(size=(b, t, hw, hw, 3))).astype(np.float32)
    gt = np.zeros((b, t, hw, hw), np.int32)
    gt[:, :, 8:20, 8:20] = 1
    gt[1:, :, 20:30, 2:12] = 2
    ov = np.zeros((b, 2), bool)
    ov[:, 0] = True
    ov[1:, 1] = True
    return frames, gt, ov


def _step(weights: str, mesh=None, grad_accum: int = 1, b: int = 2):
    net = XMem(TCFG.xmem)
    net.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    tcfg = T.TrainConfig(lr=LR, grad_accum=grad_accum)
    state = T.init_train_state(net, tcfg)
    frames, gt, ov = (torch.from_numpy(a) for a in _batch(b=b))
    state, aux = T.train_step(state, frames, gt, ov, TCFG, tcfg, mesh=mesh)
    return ({k: v.detach().clone() for k, v in state.net.state_dict().items()},
            {k: float(v) for k, v in aux.items()})


def _ranks_body(weights: str, tree: str, out: str):
    """One rank's work (spawned): a DP step over 2 clips, a DP step over 4
    clips with grad_accum 2, and `train_xmem --dp`; rank 0 also runs the
    single-process references, in the same process settings."""
    from vosesam_tpu_torch import train_xmem

    mesh = meshlib.make_mesh(ParallelConfig())
    res = {"rank": mesh.rank, "dp": _step(weights, mesh),
           "dp accum": _step(weights, mesh, grad_accum=2, b=4)}
    if mesh.rank == 0:
        res["single"] = _step(weights)
        res["single b4"] = _step(weights, b=4)
    res["entry"] = train_xmem.main(
        ["--data", tree, "--imset", "2017/val.txt", "--steps", "2", "--batch", "2",
         "--seq-length", "2", "--crop", "32", "--key-dim", "8", "--value-dim", "16",
         "--hidden-dim", "4", "--max-objects", "2", "--log-every", "1", "--device", "cpu",
         "--dp", "--save", out])
    return res


@pytest.fixture(scope="module")
def jparams():
    import jax

    from vosesam_tpu.config import XMemConfig as JXMemConfig
    from vosesam_tpu.models.xmem import network as jxnet

    return jxnet.xmem_init(jax.random.PRNGKey(0), JXMemConfig(**DIMS))


@pytest.fixture(scope="module")
def ranks(jparams, tmp_path_factory):
    import jax

    from vosesam_tpu_torch.eval.synthetic import write_tree
    from vosesam_tpu_torch.utils.checkpoint import params_from_jax

    d = tmp_path_factory.mktemp("dp")
    weights = str(d / "xmem.pth")
    torch.save(params_from_jax(jax.tree.map(np.asarray, jparams)), weights)
    write_tree(str(d / "syn"), h=48, w=64, davis_frames=5, long_frames=2, lvos_frames=1,
               ovis_frames=2)
    out = str(d / "dp.pth")
    return meshlib.run_ranks(_ranks_body, RANKS, weights, str(d / "syn" / "DAVIS"), out,
                             device="cpu", timeout_s=240, threads=2), out


def _hold(got, want, close: float):
    """Every trained leaf of a DP step against a reference step (module
    docstring)."""
    n = n_close = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (got[k] - w).abs()
        assert float(d.max()) <= 2.5 * LR, (k, float(d.max()))
        n += d.numel()
        n_close += int((d <= close).sum())
    assert n_close / n >= 0.999, (n - n_close, n)


@pytest.mark.parametrize("key,ref", [("dp", "single"), ("dp accum", "single b4")])
def test_dp_step_equals_the_single_step_over_all_clips(ranks, key, ref):
    got, _ = ranks
    before = torch.load(_weights(ranks), weights_only=True)
    (params, aux), (wparams, waux) = got[0][key], got[0][ref]
    for k in ("loss", "ce", "dice", "total"):
        assert aux[k] == pytest.approx(waux[k], rel=1e-5), k
    _hold(params, wparams, 1e-6)
    moved = sum(int(((wparams[k] - before[k]).abs() > LR / 2).sum()) for k in before)
    assert moved > 0


def test_both_ranks_end_bit_equal(ranks):
    got, _ = ranks
    for key in ("dp", "dp accum"):
        (p0, a0), (p1, a1) = got[0][key], got[1][key]
        assert a0 == a1
        for k in p0:
            assert torch.equal(p0[k], p1[k]), k


def test_dp_step_matches_jax_single_placement_step(ranks, jparams):
    import jax
    import jax.numpy as jnp

    from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
    from vosesam_tpu.config import MemoryConfig as JMemoryConfig
    from vosesam_tpu.config import XMemConfig as JXMemConfig
    from vosesam_tpu.training import trainer as JT
    from vosesam_tpu_torch.utils.checkpoint import params_from_jax

    jcfg = JFrameworkConfig(xmem=JXMemConfig(**DIMS), memory=JMemoryConfig(top_k=4),
                            dtype="float32")
    js = JT.init_train_state(jparams, JT.TrainConfig())
    js2, jaux = JT.train_step(js, *(jnp.asarray(x) for x in _batch()), jcfg, JT.TrainConfig())
    want = params_from_jax(jax.tree.map(np.asarray, js2.params))
    params, aux = ranks[0][0]["dp"]
    for k in ("loss", "ce", "dice", "total"):
        assert aux[k] == pytest.approx(float(jaux[k]), rel=1e-4), k
    _hold(params, want, 1e-5)


def test_train_xmem_dp_entry_point(ranks):
    got, out = ranks
    assert [r["entry"] for r in got] == [0, 0]
    ck = torch.load(out, weights_only=True)
    assert ck["it"] == 2 and ck["optimizer"]["count"] == 2


def _weights(ranks):
    return os.path.join(os.path.dirname(ranks[1]), "xmem.pth")
