"""The port's J&F parity runner (`python -m vosesam_tpu_torch.run_parity`),
in process on the CPU, against the root `run_parity.py` (the JAX package):

  - `--synthetic --device cpu`: five rows, J&F in [0, 1] for configs 1, 3
    and 4 (5 saves masks only, as the root runner; 2 is fps only), fps for
    2, LVOS masks written, the kernel-launch record beside the report;
  - `--chunk 2` and `--batch` (a group of one) give the sequential rows'
    J, F and J&F exactly, and the same saved masks;
  - missing inputs give SKIP rows, never an error; without imageio config 2
    says so and the others run;
  - `--reference_csv` adds dJ&F and flags |dJ&F| > 0.2;
  - the root runner's synthetic checkpoints load into the port's modules
    (strict) with the JAX package's tensors, and the port's synthetic
    checkpoints load through the JAX package's loaders with the port's
    tensors;
  - config 1's row on the port's files and tree against the JAX runner's
    row (`run_model_on_davis_set`) on the same files and tree: masks >=
    99.9% equal per frame, J / F equal where the masks are, else J within
    2 d / union (tests/test_torch_eval_e2e.py's tolerance).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import run_parity as root_rp
from tests.test_torch_eval_e2e import AGREEMENT, _agreement, _hold
from vosesam_tpu.config import FrameworkConfig as JFrameworkConfig
from vosesam_tpu.config import MemoryConfig as JMemoryConfig
from vosesam_tpu.config import RefinementConfig as JRefinementConfig
from vosesam_tpu.config import SAMConfig as JSAMConfig
from vosesam_tpu.eval import datasets as jds
from vosesam_tpu.eval import palette as jpal
from vosesam_tpu.eval import runner as jrun
from vosesam_tpu.models.sam import predictor as jpred
from vosesam_tpu.pipeline.track_anything import TrackingAnything as JTrackingAnything
from vosesam_tpu.utils import checkpoint as jckpt
from vosesam_tpu_torch import run_parity as rp
from vosesam_tpu_torch.config import SAMConfig
from vosesam_tpu_torch.eval import datasets as tds
from vosesam_tpu_torch.eval import palette as tpal
from vosesam_tpu_torch.eval import runner as trun
from vosesam_tpu_torch.eval.video_io import read_video_frames
from vosesam_tpu_torch.models.sam.predictor import Sam
from vosesam_tpu_torch.models.xmem.network import XMem
from vosesam_tpu_torch.pipeline.track_anything import TrackingAnything
from vosesam_tpu_torch.utils.checkpoint import (
    load_sam_checkpoint,
    load_xmem_checkpoint,
    params_from_jax,
)

METRICS = ("J_mean", "F_mean", "JF_mean")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _run(base, *extra):
    """run_parity's main with cwd `base` (the runners write ./result)."""
    here = os.getcwd()
    os.chdir(base)
    try:
        return rp.main(["--device", "cpu", "--out", "out", *extra])
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    base = tmp_path_factory.mktemp("parity_seq")
    return base, _run(base, "--synthetic")


def _masks(root):
    return {f: tpal.load_palette_mask(str(root / f)) for f in sorted(os.listdir(root))}


def test_synthetic_five_rows(seq):
    base, rows = seq
    assert [r["config"] for r in rows] == list(rp.CONFIGS)
    for r in rows:
        assert not r["note"].startswith("SKIP"), r
    for i in (0, 2, 3):
        assert all(0.0 <= rows[i][k] <= 1.0 for k in METRICS), rows[i]
        assert rows[i]["fps"] > 0
    assert rows[1]["fps"] > 0 and rows[1]["JF_mean"] is None
    assert rows[4]["JF_mean"] is None
    assert (base / "result" / "parity5_lvos" / "masks" / "clip" / "00000.png").exists()
    # one mask per frame of the clip (a GIF here: Pillow merges repeated frames)
    clip = base / "out" / "synthetic" / "data" / "test_sample"
    n_clip = len(read_video_frames(str(clip / sorted(os.listdir(clip))[0])))
    assert len(os.listdir(base / "out" / "sample_masks")) == n_clip > 0
    with open(base / "out" / "parity_report.json") as f:
        assert json.load(f) == rows
    with open(base / "out" / "kernel_launches.json") as f:
        launches = json.load(f)
    # on the CPU every wrapper takes its plain version
    assert launches["plain"] > 0 and launches["fused_memory_read_shared"] == 0
    for name in rp.CHECKPOINT_FILES:
        assert (base / "out" / "synthetic" / "checkpoints" / name).exists()


@pytest.mark.parametrize("flags", [("--chunk", "2"), ("--batch",)], ids=["chunk", "batch"])
def test_fast_paths_match_the_sequential_rows(seq, tmp_path, flags):
    seq_base, seq_rows = seq
    ck = seq_base / "out" / "synthetic"
    rows = _run(tmp_path, "--synthetic", "--checkpoints", str(ck / "checkpoints"),
                "--data", str(ck / "data"), *flags)
    assert [r["config"] for r in rows] == [r["config"] for r in seq_rows]
    for fast, slow in zip(rows, seq_rows):
        assert not fast["note"].startswith("SKIP"), fast
        assert {k: fast[k] for k in METRICS} == {k: slow[k] for k in METRICS}, fast["config"]
    lvos = ("result", "parity5_lvos", "masks", "clip")
    want = _masks(seq_base.joinpath(*lvos))
    got = _masks(tmp_path.joinpath(*lvos))
    assert want.keys() == got.keys() and want
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if flags[0] == "--chunk":       # config 2 runs generator_chunked
        want = _masks(seq_base / "out" / "sample_masks")
        got = _masks(tmp_path / "out" / "sample_masks")
        assert want.keys() == got.keys()
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_missing_inputs_skip(tmp_path, capsys):
    (tmp_path / "ck").mkdir()
    (tmp_path / "data").mkdir()
    rows = _run(tmp_path, "--checkpoints", str(tmp_path / "ck"), "--data", str(tmp_path / "data"))
    assert [r["config"] for r in rows] == list(rp.CONFIGS)
    assert all(r["note"].startswith("SKIP: needs") and r["JF_mean"] is None for r in rows)
    assert "PARITY REPORT" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        rp.main(["--device", "cpu"])             # neither inputs nor --synthetic


def test_without_imageio_only_config_2_skips(seq, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(rp, "imageio_missing", lambda: "reading or writing video needs imageio")
    rows = _run(tmp_path, "--synthetic", "--checkpoints",
                str(seq[0] / "out" / "synthetic" / "checkpoints"), "--configs", "1", "2")
    assert rows[1]["note"] == "SKIP: needs imageio to read the test_sample clip"
    assert not rows[0]["note"].startswith("SKIP") and rows[0]["JF_mean"] is not None
    assert not (tmp_path / "out" / "synthetic" / "data" / "test_sample").exists()
    assert "test_sample clip: reading or writing video needs imageio" in capsys.readouterr().out
    # a tree that has the clip: it cannot be read either
    rows = _run(tmp_path, "--checkpoints", str(seq[0] / "out" / "synthetic" / "checkpoints"),
                "--data", str(seq[0] / "out" / "synthetic" / "data"), "--configs", "2")
    assert rows == [{"config": rp.CONFIGS[1], "J_mean": None, "F_mean": None, "JF_mean": None,
                     "fps": None, "note": "SKIP: needs imageio to read the test_sample clip"}]


def test_reference_csv_deltas(seq, tmp_path, capsys):
    _, seq_rows = seq
    jf1, jf3 = seq_rows[0]["JF_mean"], seq_rows[2]["JF_mean"]
    ref = tmp_path / "ref.csv"
    ref.write_text("config,J_mean,F_mean,JF_mean\n"
                   f"{rp.CONFIGS[0]},0,0,{jf1 - 0.1}\n"
                   f"{rp.CONFIGS[2]},0,0,{jf3 + 0.5}\n")
    rows = _run(tmp_path, "--synthetic", "--checkpoints",
                str(seq[0] / "out" / "synthetic" / "checkpoints"),
                "--data", str(seq[0] / "out" / "synthetic" / "data"),
                "--configs", "1", "3", "--reference_csv", str(ref))
    assert rows[0]["dJF"] == pytest.approx(0.1) and rows[1]["dJF"] == pytest.approx(-0.5)
    out = capsys.readouterr().out
    lines = {ln.split()[0]: ln for ln in out.splitlines() if ln.startswith(("1_", "3_"))}
    assert "dJ&F" in out
    assert lines[rp.CONFIGS[0]].rstrip().endswith("OK")
    assert lines[rp.CONFIGS[2]].rstrip().endswith("FAIL")


# --------------------------------------------------- the checkpoint schemas

def _jax_sam_cfgs():
    kw = dict(image_size=128, window_size=7, vit_dims=root_rp._SYN_VIT)
    return JSAMConfig(model_type="vit_h", **kw), JSAMConfig(model_type="vit_h", hq=True, **kw)


def _port_sam_cfgs():
    return (SAMConfig(model_type="vit_h", **rp.SYN_SAM),
            SAMConfig(model_type="vit_h", hq=True, **rp.SYN_SAM))


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_root_synthetic_checkpoints_load_in_the_port(tmp_path):
    sam_cfg, samhq_cfg = _jax_sam_cfgs()
    root_rp._syn_checkpoints(str(tmp_path), sam_cfg, samhq_cfg)
    sd, xcfg = load_xmem_checkpoint(str(tmp_path / "XMem-s012.pth"))
    assert (xcfg.key_dim, xcfg.value_dim, xcfg.hidden_dim) == (8, 16, 4)
    net = XMem(xcfg)
    net.load_state_dict(sd, strict=True)
    raw = torch.load(tmp_path / "XMem-s012.pth", weights_only=True)
    _assert_same({k: v for k, v in net.state_dict().items() if k in raw}, raw)
    for fname, jcfg, tcfg in zip(rp.CHECKPOINT_FILES[1:], (sam_cfg, samhq_cfg),
                                 _port_sam_cfgs()):
        sam = Sam(tcfg)
        sam.load_state_dict(load_sam_checkpoint(str(tmp_path / fname)), strict=True)
        want = params_from_jax(jax.tree.map(np.asarray, jpred.sam_init(jax.random.PRNGKey(1),
                                                                       jcfg)))
        _assert_same(sam.state_dict(), want)


def test_port_synthetic_checkpoints_load_in_jax(tmp_path):
    rp.write_checkpoints(str(tmp_path), *_port_sam_cfgs())
    raw = torch.load(tmp_path / "XMem-s012.pth", weights_only=True)
    tree, jx = jckpt.load_xmem_checkpoint(str(tmp_path / "XMem-s012.pth"))
    assert (jx.key_dim, jx.value_dim, jx.hidden_dim) == (8, 16, 4)
    _assert_same(params_from_jax(jax.tree.map(np.asarray, tree)), raw)
    for fname, jcfg in zip(rp.CHECKPOINT_FILES[1:], _jax_sam_cfgs()):
        raw = torch.load(tmp_path / fname, weights_only=True)
        got = params_from_jax(jax.tree.map(np.asarray, jckpt.load_sam_checkpoint(
            str(tmp_path / fname), jcfg)))
        _assert_same(got, raw)


# ------------------------------------------------- config 1 against JAX's

def test_config1_matches_the_jax_runner(seq, tmp_path, monkeypatch):
    base, rows = seq
    ck = str(base / "out" / "synthetic" / "checkpoints" / "XMem-s012.pth")
    davis = str(base / "out" / "synthetic" / "data" / "DAVIS")
    monkeypatch.chdir(tmp_path)
    jcfg = JFrameworkConfig(memory=JMemoryConfig(**{
        k: getattr(rp.SYN_MEMORY, k) for k in ("max_mid_term_frames", "min_mid_term_frames",
                                              "max_long_term_elements", "num_prototypes",
                                              "top_k", "mem_every")}),
        refinement=JRefinementConfig(use_refinement=False), dtype="float32")
    jta = JTrackingAnything(xmem_checkpoint=ck, cfg=jcfg)
    jrow = next(jrun.run_model_on_davis_set(
        "jax", jta, jds.DavisDataset(davis, "2016/val.txt", single_object=True),
        save_masks=True, max_videos=1).iterrows())[1]
    # the port's runner on the model run_parity builds for config 1, its masks kept
    tta = TrackingAnything(xmem_checkpoint=ck, cfg=rp.FrameworkConfig(
        memory=rp.SYN_MEMORY, refinement=rp.RefinementConfig(use_refinement=False),
        dtype="float32"), device="cpu")
    ds = tds.DavisDataset(davis, "2016/val.txt", single_object=True)
    trow = trun.run_model_on_davis_set("port", tta, ds, save_masks=True, max_videos=1)[0]
    assert {k: trow[k] for k in METRICS} == {k: rows[0][k] for k in METRICS}
    files = sorted(os.listdir("result/jax/masks/bear"))
    tm = [tpal.load_palette_mask(os.path.join("result/port/masks/bear", f)) for f in files]
    jm = [jpal.load_palette_mask(os.path.join("result/jax/masks/bear", f)) for f in files]
    assert _agreement(tm, jm) >= AGREEMENT
    _hold(trow, jrow, tm, jm, [ds.load_mask("bear", f) for f in files])
