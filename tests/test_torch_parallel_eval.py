"""Data-parallel evaluation (`vosesam_tpu_torch/parallel/evaluation.py`,
`eval/runner.py` with `batched=`, the `--batch` entry point) on 2 gloo
ranks on the CPU, against the JAX package's `BatchedGenerator` on a (2, 1)
mesh and against the port's own sequential path, with the same weights
(the JAX inits written as official-schema checkpoints, as
test_torch_eval_e2e.py does; the ranks load them).

Three uneven videos (5, 3 and 4 frames: rank 0 runs two, rank 1 one; the
JAX class pads its batch to 4 lanes and steps the short ones on their last
frames) of moving squares on a fixed texture at 48 x 64.

Tolerances: against JAX, masks agree per frame on >= 99.9% of pixels
(ROADMAP C8: random-weight logits of |z| ~ 1e3 let fp32 reassociation flip
near-ties) and `scores` / `label_scores` have the same objects; against the
port's sequential `Tracker` (the same code and weights per video) masks
and scores are equal, with refinement too; `chunk=2` equals per frame (the
chunked path batches the same operations); the batched runner's
CSVs equal the sequential runner's but for the fps column.
"""

import csv
import os

import numpy as np
import pytest
import torch

from vosesam_tpu_torch.config import (
    FrameworkConfig,
    MemoryConfig,
    RefinementConfig,
    SAMConfig,
    XMemConfig,
)
from vosesam_tpu_torch.eval import datasets as tds
from vosesam_tpu_torch.eval import runner as trun
from vosesam_tpu_torch.eval.synthetic import write_tree
from vosesam_tpu_torch.parallel import mesh as meshlib
from vosesam_tpu_torch.parallel.evaluation import BatchedGenerator
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything

RANKS = 2
H, W = 48, 64
LENGTHS = (5, 3, 4)
AGREEMENT = 0.999
TINY = dict(model_type="vit_b", image_size=128, window_size=7,
            vit_dims=(("vit_b", 64, 2, 2, (1,)),), hq=True, encode_rect=True)
MEM = dict(max_mid_term_frames=3, min_mid_term_frames=2, max_long_term_elements=64,
           num_prototypes=8, top_k=8, mem_every=2)
REFINE = dict(mode="both_neg", point_algorithm="C", optimized=False, min_region_area=10.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite runs several worker processes side by side (and this file
    spawns ranks): keep this process's torch work from taking every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def port_cfg(refine: bool) -> FrameworkConfig:
    rk = REFINE if refine else dict(use_refinement=False)
    return FrameworkConfig(xmem=XMemConfig(max_objects=2), memory=MemoryConfig(**MEM),
                           sam=SAMConfig(**TINY), refinement=RefinementConfig(**rk),
                           dtype="float32")


def videos():
    """Three uneven videos, palette labels {3} or {3, 7}."""
    rng = np.random.default_rng(5)
    vids, temps = [], []
    for i, n in enumerate(LENGTHS):
        tex = rng.integers(0, 255, (H, W, 3), np.uint8)
        frames, first = [], None
        for t in range(n):
            img, m = tex.copy(), np.zeros((H, W), np.uint8)
            img[8 + t:22 + t, 6 + 2 * t:24 + 2 * t] = (230, 40, 40)
            m[8 + t:22 + t, 6 + 2 * t:24 + 2 * t] = 3
            if i != 1:
                img[26:42 - t, 34 - t:56] = (40, 200, 60)
                m[26:42 - t, 34 - t:56] = 7
            frames.append(img)
            first = m if first is None else first
        vids.append(frames)
        temps.append(first)
    return vids, temps


def load_model(ckpt: dict, refine: bool) -> TrackingAnything:
    return TrackingAnything(sam_checkpoint=ckpt.get("sam") if refine else None,
                            xmem_checkpoint=ckpt["xmem"], cfg=port_cfg(refine), device="cpu")


def _sequential(ckpt, refine):
    ta = load_model(ckpt, refine)
    vids, temps = videos()
    out = []
    for v, t in zip(vids, temps):
        ta.xmem.clear_memory()
        masks, _, _, scores = ta.generator(v, t)
        out.append((masks, scores))
    return out


def _ranks_body(ckpt: dict, tree: str, out_dir: str):
    """One rank's work (spawned): batched runs, the batched runner and the
    `--batch` entry point, in `out_dir` (rank 0 writes); rank 0 also runs
    the sequential references, in the same process settings."""
    from vosesam_tpu_torch import run_davis_test

    vids, temps = videos()
    rank = meshlib.world()[0]
    res = {"rank": rank}
    for refine in (False, True):
        ta = load_model(ckpt, refine)
        mesh = meshlib.make_mesh(ta.cfg.parallel)
        assert mesh.shape == (RANKS, 1)
        gen = BatchedGenerator(ta.xmem_net, ta.sam, ta.cfg, mesh=mesh, device="cpu")
        res[f"refine={refine}"] = gen.run(vids, temps)
        if not refine:
            res["chunk=2"] = BatchedGenerator(ta.xmem_net, ta.sam, ta.cfg, mesh=mesh, chunk=2,
                                              device="cpu").run(vids, temps)
            os.chdir(out_dir)
            davis = tds.DavisDataset(os.path.join(tree, "DAVIS"))
            res["rows"] = trun.run_model_on_davis_set("batched", ta, davis, batched=gen)
            if rank == 0:
                res["seq_rows"] = trun.run_model_on_davis_set("seq", load_model(ckpt, False),
                                                              davis)
        if rank == 0:
            res[f"sequential refine={refine}"] = _sequential(ckpt, refine)
    run_davis_test.main(["--davis_root", os.path.join(tree, "DAVIS"), "--device", "cpu",
                         "--configs", "baseline", "--batch", "--mesh", "2x1",
                         "--xmem_checkpoint", ckpt["xmem"]])
    return res


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The JAX facade's weights (XMem PRNGKey(0), SAM PRNGKey(1)) as
    official-schema files, and the JAX facade itself."""
    from tests.test_torch_eval_e2e import make_models

    d = tmp_path_factory.mktemp("ckpt")
    jta, _ = make_models("both_neg_C", d)
    return {"xmem": str(d / "xmem.pth"), "sam": str(d / "sam_hq.pth"), "jax": jta}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    write_tree(root, H, W, seed=0, davis_frames=4, long_frames=2, lvos_frames=2,
               ovis_frames=2)
    return root


@pytest.fixture(scope="module")
def ranks(ckpt, tree, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    paths = {k: v for k, v in ckpt.items() if k != "jax"}
    got = meshlib.run_ranks(_ranks_body, RANKS, paths, tree, out, device="cpu", timeout_s=300,
                            threads=1)
    return got, out


def _agreement(a, b):
    return min(float((x == y).mean()) for x, y in zip(a, b))


def test_every_rank_returns_every_video_in_order(ranks):
    got, _ = ranks
    assert [r["rank"] for r in got] == [0, 1]
    for key in ("refine=False", "refine=True", "chunk=2"):
        a, b = got[0][key], got[1][key]
        assert [len(v["masks"]) for v in a] == list(LENGTHS)
        for va, vb in zip(a, b):
            assert all(np.array_equal(x, y) for x, y in zip(va["masks"], vb["masks"]))
            assert va["scores"] == vb["scores"] and va["label_scores"] == vb["label_scores"]


@pytest.mark.parametrize("refine", [False, True])
def test_batched_lanes_equal_the_sequential_tracker(ranks, refine):
    got = ranks[0][0][f"refine={refine}"]
    for lane, (masks, scores) in zip(got, ranks[0][0][f"sequential refine={refine}"]):
        assert all(np.array_equal(x, y) for x, y in zip(lane["masks"], masks))
        assert lane["scores"] == scores


def test_chunked_lanes_equal_per_frame_lanes(ranks):
    got = ranks[0][0]
    for a, b in zip(got["chunk=2"], got["refine=False"]):
        assert all(np.array_equal(x, y) for x, y in zip(a["masks"], b["masks"]))
        np.testing.assert_allclose(np.concatenate([np.asarray(s) for s in a["scores"]]),
                                   np.concatenate([np.asarray(s) for s in b["scores"]]),
                                   rtol=1e-6, atol=1e-6)


def test_batched_generator_matches_jax_on_a_two_device_mesh(ranks, ckpt):
    import jax
    from jax.sharding import Mesh

    from tests.test_torch_eval_e2e import _cfgs
    from vosesam_tpu.parallel.evaluation import BatchedGenerator as JBatchedGenerator

    jta = ckpt["jax"]
    jcfg, _ = _cfgs("baseline")
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]).reshape(RANKS, 1), ("data", "model"))
    vids, temps = videos()
    want = JBatchedGenerator(jta.xmem_params, None, jcfg, mesh=mesh).run(vids, temps)
    got = ranks[0][0]["refine=False"]
    for lane, (g, w) in enumerate(zip(got, want)):
        assert len(g["masks"]) == len(w["masks"]) == LENGTHS[lane]
        assert _agreement(g["masks"], w["masks"]) >= AGREEMENT, lane
        assert [len(s) for s in g["scores"]] == [len(s) for s in w["scores"]]
        assert [sorted(d) for d in g["label_scores"]] == [sorted(d) for d in w["label_scores"]]


def test_frames_of_different_sizes_raise():
    ta = TrackingAnything(cfg=port_cfg(False), device="cpu")
    gen = BatchedGenerator(ta.xmem_net, None, ta.cfg, device="cpu")
    vids, temps = videos()
    with pytest.raises(ValueError, match="share"):
        gen.run([vids[0], [f[:32] for f in vids[1]]], temps[:2])


def _csv_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r.pop("fps", None)
    return rows


def _without_fps(rows):
    """The rows with fps dropped and NaN as a string, so that == holds them."""
    return [{k: "nan" if isinstance(v, float) and v != v else v for k, v in r.items()
             if k != "fps"} for r in rows]


def test_batched_runner_writes_the_sequential_csvs(ranks):
    got, out = ranks
    for r in got:
        assert _without_fps(r["rows"]) == _without_fps(got[0]["seq_rows"])
    for name in ("whole_metrics.csv", "per_object_metrics.csv"):
        assert _csv_rows(os.path.join(out, "result", "batched", name)) == \
               _csv_rows(os.path.join(out, "result", "seq", name))
    # rank 0 alone wrote the ledger: the batched and sequential runs and --batch
    with open(os.path.join(out, "result", "all_tests.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 3


def test_batch_entry_point_runs_on_two_ranks(ranks):
    _, out = ranks
    runs = [r for r in os.listdir(os.path.join(out, "result")) if r.startswith("davis2017_")]
    assert len(runs) == 1
    rows = _csv_rows(os.path.join(out, "result", runs[0], "whole_metrics.csv"))
    assert [r["video"] for r in rows] == ["bear", "bike-packing"]
    assert all(0.0 <= float(r["JF_mean"]) <= 1.0 for r in rows)
