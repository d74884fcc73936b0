"""The port's multi-device layer (`vosesam_tpu_torch/parallel/`): the mesh,
the exact chunked top-k and the memory-axis-sharded XMem read, against the
JAX package's on the same numpy inputs.

The port runs 2 ranks of one gloo group on the CPU (`run_ranks`: spawned
processes, a `file://` rendezvous, a deadline); JAX runs on the virtual
8-CPU mesh of conftest.py. The spawned ranks import this module by name,
so it imports JAX only inside the tests.

Tolerances: top-k values exactly (the same elements); the sharded read
against the single read and against JAX's sharded read 1e-4 absolute and
relative (JAX's own test, tests/test_parallel.py); a manager rollout with
`memory_axis_shards=2` against the single-device rollout 2e-5 (JAX's).
Inputs are continuous, so no two similarities tie at the k-th value (C5).
"""

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import MemoryConfig, ParallelConfig, XMemConfig
from vosesam_tpu_torch.memory import manager as tman
from vosesam_tpu_torch.memory import rings as trings
from vosesam_tpu_torch.ops.memory_attention import hierarchical_top_k, read_memory_multiobject
from vosesam_tpu_torch.parallel import mesh as meshlib
from vosesam_tpu_torch.parallel.memory_shard import make_sharded_read, sharded_memory_read_local

RANKS = 2
READ_TOL = 1e-4
ROLLOUT_TOL = 2e-5
ROLL_MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=32,
                num_prototypes=4, top_k=4, mem_every=2, fused_read=False)
ROLL_XM = dict(max_objects=2, key_dim=16, value_dim=24, hidden_dim=8)
ROLL_HW = (4, 2)      # LT 32 + work 3 x 8 = 56 slots, divisible by 2
ROLL_FRAMES = 40


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side (and this file
    spawns ranks): keep this process's torch work from taking every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _read_inputs(seed=0):
    """JAX's test shapes: O 2, M 512, Q 64, Ck 32, Cv 48, k 8."""
    rng = np.random.default_rng(seed)
    o, m, q, ck, cv = 2, 512, 64, 32, 48
    mk = rng.standard_normal((m, ck)).astype(np.float32)
    ms = rng.uniform(1, 4, (m,)).astype(np.float32)
    qk = rng.standard_normal((q, ck)).astype(np.float32)
    qe = rng.uniform(0, 1, (q, ck)).astype(np.float32)
    mv = rng.standard_normal((o, m, cv)).astype(np.float32)
    kv = rng.uniform(0, 1, (m,)) > 0.2
    vv = (rng.uniform(0, 1, (o, m)) > 0.3) & kv[None]
    return (mk, ms, qk, qe, mv, kv, vv), 8


def _rollout(pcfg):
    """ROLL_FRAMES reads and every mem_every-th write through the manager
    (consolidation fires); returns every read."""
    mcfg, xcfg = MemoryConfig(**ROLL_MEM), XMemConfig(**ROLL_XM)
    h16, w16 = ROLL_HW
    st = trings.init_memory(mcfg, xcfg, ROLL_HW)
    st.obj_valid = torch.tensor([True, False])
    rr = np.random.default_rng(7)
    reads = []
    for i in range(ROLL_FRAMES):
        qk = torch.from_numpy(rr.standard_normal((h16, w16, 16)).astype(np.float32))
        qe = torch.from_numpy(rr.uniform(0, 1, (h16, w16, 16)).astype(np.float32))
        out, st = tman.match_memory(st, qk, qe, mcfg, pcfg)
        reads.append(out.numpy().copy())
        if i % mcfg.mem_every == 0:
            sh = torch.from_numpy(rr.uniform(1, 4, (h16, w16, 1)).astype(np.float32))
            val = torch.from_numpy(rr.standard_normal((2, h16, w16, 24)).astype(np.float32))
            st = tman.add_memory(st, qk, sh, qe, val, st.obj_valid, mcfg, h16 * w16)
    assert int(st.long.key_valid.sum()) > 0, "LT consolidation not hit"
    return reads


def _ranks_body():
    """One rank's work (spawned): the sharded read from full inputs, the
    local read on this rank's slice, a sharded manager rollout, and rank
    0's tensors replicated to every rank."""
    (mk, ms, qk, qe, mv, kv, vv), k = _read_inputs()
    t = [torch.from_numpy(a) for a in (mk, ms, qk, qe, mv)]
    valid = torch.from_numpy(kv[None] & vv)
    out, usage = make_sharded_read(k)(*t, valid)
    r, n = meshlib.world()
    mesh = meshlib.make_mesh(ParallelConfig())
    mine = {"w": torch.full((3,), float(r)), "meta": [torch.tensor([r]), "text"]}
    got = meshlib.replicated(mine, mesh)
    sl = slice(r * mk.shape[0] // n, (r + 1) * mk.shape[0] // n)
    local_out, local_usage = sharded_memory_read_local(
        t[0][sl], t[1][sl], t[2], t[3], t[4][:, sl], valid[:, sl], k)
    rollout = _rollout(ParallelConfig(memory_axis_shards=RANKS))
    return dict(rank=r, world=n, out=out.numpy(), usage=usage.numpy(),
                local_out=local_out.numpy(), local_usage=local_usage.numpy(), rollout=rollout,
                mesh=(mesh.shape, mesh.data_index, mesh.data_group is not None),
                replicated=(got["w"].tolist(), got["meta"][0].tolist(), got["meta"][1],
                            mine["w"].tolist()))


@pytest.fixture(scope="module")
def ranks():
    return meshlib.run_ranks(_ranks_body, RANKS, device="cpu", timeout_s=90, threads=1)


# ---------------------------------------------------------------- top-k

@pytest.mark.parametrize("m,k", [(300, 8), (1500, 8), (2048, 30), (1100, 700)])
def test_hierarchical_top_k_matches_jax(m, k):
    import jax.numpy as jnp

    from vosesam_tpu.ops.memory_attention import hierarchical_top_k as jtopk

    sim = np.random.default_rng(m).standard_normal((16, m)).astype(np.float32)
    got = hierarchical_top_k(torch.from_numpy(sim), k).numpy()
    want = np.asarray(jtopk(jnp.asarray(sim), k))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, -np.sort(-sim, axis=-1)[:, :min(k, m)])


# ----------------------------------------------------------------- mesh

@pytest.mark.parametrize("pc", [dict(), dict(model_parallel=2),
                                dict(data_parallel=4, model_parallel=2),
                                dict(data_parallel=2, model_parallel=4)])
def test_make_mesh_matches_jax(pc):
    import jax

    from vosesam_tpu.config import ParallelConfig as JParallelConfig
    from vosesam_tpu.parallel import mesh as jmesh

    devs = jax.devices()[:8]
    want = jmesh.make_mesh(JParallelConfig(**pc), devs)
    got = meshlib.make_mesh(ParallelConfig(**pc), ranks=range(8))
    assert got.shape == want.devices.shape
    assert got.axis_names == want.axis_names
    np.testing.assert_array_equal(got.devices, np.vectorize(lambda d: d.id)(want.devices))


@pytest.mark.parametrize("pc", [dict(data_parallel=3), dict(model_parallel=3),
                                dict(data_parallel=4, model_parallel=4)])
def test_make_mesh_errors_match_jax(pc):
    import jax

    from vosesam_tpu.config import ParallelConfig as JParallelConfig
    from vosesam_tpu.parallel import mesh as jmesh

    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(JParallelConfig(**pc), jax.devices()[:8])
    with pytest.raises(ValueError) as terr:
        meshlib.make_mesh(ParallelConfig(**pc), ranks=range(8))
    assert str(terr.value) == str(jerr.value)


def test_single_process_mesh_and_shard_batch():
    mesh = meshlib.make_mesh(ParallelConfig())
    assert mesh.shape == (1, 1) and mesh.data_group is None and mesh.data_index == 0
    x = torch.arange(12).reshape(4, 3)
    torch.testing.assert_close(meshlib.shard_batch({"x": (x,)}, mesh)["x"][0], x)
    # a layout of 4 ranks, seen from rank 0: its slice of the leading axis
    four = meshlib.make_mesh(ParallelConfig(), ranks=range(4))
    torch.testing.assert_close(meshlib.shard_batch(x, four), x[:1])
    with pytest.raises(ValueError, match="does not divide"):
        meshlib.shard_batch(torch.zeros(3, 2), four)


def test_tensor_parallel_and_approx_top_k_raise_naming_what_is_missing():
    """Tensor parallelism over a model axis without a process group raises
    (tests/test_torch_parallel_tp.py holds the sharded encoder); the
    TPU-only approximate top-k raises."""
    from vosesam_tpu_torch.config import SAMConfig
    from vosesam_tpu_torch.models.sam.predictor import Sam

    sam = Sam(SAMConfig(model_type="vit_b", image_size=64,
                        vit_dims=(("vit_b", 64, 2, 2, (1,)),)))
    two = meshlib.make_mesh(ParallelConfig(model_parallel=2), ranks=range(2))
    with pytest.raises(ValueError, match="no process group"):
        meshlib.shard_sam_params_tp(sam, two, ParallelConfig(model_parallel=2))
    mcfg = MemoryConfig(**dict(ROLL_MEM, top_k_approx=True))
    st = trings.init_memory(mcfg, XMemConfig(**ROLL_XM), ROLL_HW)
    q = torch.zeros(ROLL_HW + (16,))
    with pytest.raises(NotImplementedError, match="approx"):
        tman.match_memory(st, q, q, mcfg)


# ----------------------------------------------------- the sharded read

def test_ranks_form_one_group(ranks):
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["world"] == RANKS for r in ranks)
    assert [r["mesh"] for r in ranks] == [((RANKS, 1), 0, True), ((RANKS, 1), 1, True)]
    # rank 0's tensors on every rank, the other leaves untouched, the input not changed
    for r in ranks:
        assert r["replicated"] == ([0.0] * 3, [0], "text", [float(r["rank"])] * 3)
    np.testing.assert_array_equal(ranks[0]["out"], ranks[1]["out"])
    np.testing.assert_array_equal(ranks[0]["usage"], ranks[1]["usage"])


def test_sharded_read_matches_the_single_read(ranks):
    (mk, ms, qk, qe, mv, kv, vv), k = _read_inputs()
    out, usage = read_memory_multiobject(
        *(torch.from_numpy(a) for a in (mk, ms, mv, qk, qe, kv, vv)), k, return_usage=True)
    for r in ranks:
        np.testing.assert_allclose(r["out"], out.numpy(), atol=READ_TOL, rtol=READ_TOL)
        np.testing.assert_allclose(r["usage"], usage.numpy(), atol=READ_TOL, rtol=READ_TOL)
        np.testing.assert_allclose(r["local_out"], out.numpy(), atol=READ_TOL, rtol=READ_TOL)
    half = mk.shape[0] // RANKS
    np.testing.assert_allclose(np.concatenate([r["local_usage"] for r in ranks]),
                               usage.numpy(), atol=READ_TOL, rtol=READ_TOL)
    assert ranks[0]["local_usage"].shape == (half,)


def test_sharded_read_matches_jax_over_two_devices(ranks):
    import jax
    from jax.sharding import Mesh

    from vosesam_tpu.parallel.memory_shard import make_sharded_read

    (mk, ms, qk, qe, mv, kv, vv), k = _read_inputs()
    read = make_sharded_read(Mesh(np.asarray(jax.devices()[:RANKS]), ("mem",)), "mem", k)
    jout, juse = read(mk, ms, qk, qe, mv, kv[None] & vv)
    for r in ranks:
        np.testing.assert_allclose(r["out"], np.asarray(jout), atol=READ_TOL, rtol=READ_TOL)
        np.testing.assert_allclose(r["usage"], np.asarray(juse), atol=READ_TOL, rtol=READ_TOL)


def test_sharded_manager_rollout_matches_the_single_device_rollout(ranks):
    single = _rollout(None)
    for r in ranks:
        for i, (a, b) in enumerate(zip(single, r["rollout"])):
            np.testing.assert_allclose(b, a, rtol=ROLLOUT_TOL, atol=ROLLOUT_TOL,
                                       err_msg=f"frame {i}")


def test_shard_count_must_equal_the_group_size():
    mcfg = MemoryConfig(**ROLL_MEM)
    st = trings.init_memory(mcfg, XMemConfig(**ROLL_XM), ROLL_HW)
    q = torch.zeros(ROLL_HW + (16,))
    with pytest.raises(ValueError, match="memory_axis_shards=2"):
        tman.match_memory(st, q, q, mcfg, ParallelConfig(memory_axis_shards=2))


# -------------------------------------------------------------- launcher

def _hang():
    import time

    time.sleep(600)


def _fail():
    raise RuntimeError("rank failed on purpose")


def test_run_ranks_stops_at_its_deadline_and_on_a_failed_rank():
    with pytest.raises(TimeoutError, match="still running"):
        meshlib.run_ranks(_hang, RANKS, device="cpu", timeout_s=6)
    with pytest.raises(Exception, match="on purpose"):
        meshlib.run_ranks(_fail, RANKS, device="cpu", timeout_s=60)
