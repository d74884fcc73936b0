"""The port's checkpoint-day pipeline (`python -m
vosesam_tpu_torch.checkpoint_day`) against the root
`scripts/checkpoint_day.py`:

  - `compute_verdict` returns the root's decision, deltas and sets on the
    five cases of `tests/test_checkpoint_day.py::TestVerdictLogic` and on
    row sets drawn by hypothesis (J&F present, absent or None per phase and
    config, gates across the deltas' range);
  - one `--synthetic --device cpu` run end to end (phases A and B as
    `run_parity` processes on the CPU, chunk 2, a 32x64 letterbox): both
    phases run every config they ask for, deltas are finite, a verdict is
    written, phase B reads phase A's files.
"""

import importlib.util
import json
import math
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from vosesam_tpu_torch import checkpoint_day as cd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root():
    spec = importlib.util.spec_from_file_location(
        "root_checkpoint_day", os.path.join(REPO, "scripts", "checkpoint_day.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROOT = _root()


def _rows(**jf):
    return [{"config": c, "JF_mean": v} for c, v in jf.items()]


C = cd.JF_CONFIGS
CASES = {
    "promote_when_all_within_gate": (_rows(**{c: 0.80 for c in C}),
                                     _rows(**{c: 0.75 for c in C}), 0.2),
    "keep_when_any_delta_exceeds_gate": (
        _rows(**{c: 0.80 for c in C}),
        _rows(**{c: (0.50 if c == C[0] else 0.79) for c in C}), 0.2),
    "keep_when_comparison_incomplete": (_rows(**{c: 0.80 for c in C}),
                                        _rows(**{c: 0.80 for c in C[:2]}), 0.2),
    "excluded_configs_do_not_block_promotion": (_rows(**{c: 0.8 for c in C[:2]}),
                                                _rows(**{c: 0.8 for c in C[:2]}), 0.2),
    "keep_when_nothing_compared": ([], [], 0.2),
}


def test_the_configs_are_the_roots():
    assert cd.JF_CONFIGS == ROOT.JF_CONFIGS


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdict_equals_the_roots(case):
    official, letterbox, gate = CASES[case]
    got = cd.compute_verdict(official, letterbox, gate)
    assert got == ROOT.compute_verdict(official, letterbox, gate)
    want_verdict = "promote" if case.startswith(("promote", "excluded")) else "keep"
    assert got["verdict"] == want_verdict


_jf = st.one_of(st.none(), st.floats(0.0, 1.0, allow_nan=False))
_phase = st.dictionaries(st.sampled_from(C + ("2_test_sample_full_loop",)), _jf, max_size=5)


@settings(max_examples=200, deadline=None, database=None)
@given(official=_phase, letterbox=_phase, gate=st.floats(0.0, 0.5, allow_nan=False))
def test_verdict_equals_the_roots_on_drawn_rows(official, letterbox, gate):
    rows_o = [{"config": c, "JF_mean": v, "note": ""} for c, v in official.items()]
    rows_l = [{"config": c, "JF_mean": v, "note": ""} for c, v in letterbox.items()]
    got = cd.compute_verdict(rows_o, rows_l, gate)
    assert got == ROOT.compute_verdict(rows_o, rows_l, gate)
    assert set(got["deltas"]) | set(got["incomplete"]) | set(got["excluded"]) == set(C)


def test_synthetic_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    report = cd.main(["--synthetic", "--device", "cpu", "--chunk", "2",
                      "--letterbox", "32x64", "--out", "cd"])
    with open(tmp_path / "cd" / "checkpoint_day_report.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert [r["config"][0] for r in report["official"]] == list("12345")
    assert [r["config"][0] for r in report["letterbox"]] == list("1345")
    for r in report["official"] + report["letterbox"]:
        assert not r["note"].startswith("SKIP"), r
    deltas = report["letterbox_jf_delta"]
    assert set(deltas) == set(C[:3]) and all(math.isfinite(d) for d in deltas.values())
    assert report["letterbox_excluded"] == [C[3]]         # LVOS: masks only
    assert report["letterbox_verdict"] == cd.compute_verdict(
        report["official"], report["letterbox"], 0.2)["verdict"]
    assert report["letterbox_geometry"] == "32x64"
    assert "CHECKPOINT-DAY VERDICT" in capsys.readouterr().out
    # phase B read phase A's synthetic files
    assert (tmp_path / "cd" / "official" / "synthetic" / "checkpoints"
            / "sam_hq_vit_h.pth").exists()
    assert not (tmp_path / "cd" / "letterbox" / "synthetic").exists()
    for phase in ("official", "letterbox"):
        with open(tmp_path / "cd" / phase / "kernel_launches.json") as f:
            assert json.load(f)["plain"] > 0
