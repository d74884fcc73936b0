"""End to end, `both_neg_C` with the score gate off (random-weight SAM
never passes the 0.94 gate, ROADMAP C13): the port and the JAX package
track the same synthetic DAVIS tree (2 videos, 4 frames each) through XMem
and tiny-width SAM-HQ refinement, with the same weights, through their own
runners. Masks and metrics are held as test_torch_eval_e2e.py says.
"""

import pytest

from tests.test_torch_eval import small_tree
from tests.test_torch_eval_e2e import davis_end_to_end, make_models


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    return small_tree(str(tmp_path_factory.mktemp("tree")))


def test_refined_davis_end_to_end_matches_jax(png_tree, tmp_path_factory, tmp_path, monkeypatch):
    jta, tta = make_models("both_neg_C", tmp_path_factory.mktemp("ckpt"))
    assert jta.sam_params is not None and tta.sam is not None
    monkeypatch.chdir(tmp_path)
    davis_end_to_end(jta, tta, png_tree)
