"""The port's morphology and prompt generation (`ops/morphology.py`,
`ops/prompts.py`) against the JAX package, exactly.

Seeded 48x64 masks with several blobs of equal size (tied blob areas),
thin bars (tied skeleton scores), a speck under the area cut, and an empty
object; the port runs all objects (and frames) in one batch where JAX
vmaps. Every output is compared for equality: the sums are of integers
below 2^24, so they are exact in fp32 in both frameworks, and ties are
broken lowest-index-first in both (`lax.top_k`; the port sorts stably).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vosesam_tpu.config import RefinementConfig as JRefinementConfig
from vosesam_tpu.ops import morphology as jm
from vosesam_tpu.ops import prompts as jp
from vosesam_tpu_torch.config import REFINEMENT_MODES, RefinementConfig
from vosesam_tpu_torch.ops import morphology as tm
from vosesam_tpu_torch.ops import prompts as tp

H, W = 48, 64
RCFG = dict(min_region_area=10.0)


def _masks():
    r = np.random.default_rng(7)
    m = np.zeros((4, H, W), bool)
    m[0, 4:14, 4:14] = True                     # two blobs of equal area
    m[0, 30:40, 40:50] = True
    m[0, 20:22, 20:21] = True                   # a speck below the area cut
    m[1, 10:12, 2:60] = True                    # thin bars: tied skeleton scores
    m[1, 2:46, 30:32] = True
    m[2] = r.uniform(size=(H, W)) > 0.6         # noise: many tiny blobs
    m[2, 16:36, 8:28] = True
    return m                                    # object 3 is empty


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_neighbours_erode_dilate_boundary():
    m = _masks()
    for o in range(4):
        _eq(tm.neighbor_count(_t(m[o])), jm.neighbor_count(jnp.asarray(m[o])))
        _eq(tm.dilate(_t(m[o]), 2), jm.dilate(jnp.asarray(m[o]), 2))
        _eq(tm.erode(_t(m[o]), 2), jm.erode(jnp.asarray(m[o]), 2))
        _eq(tm.boundary(_t(m[o])), jm.boundary(jnp.asarray(m[o])))
    _eq(tm.boundary(_t(m)), jax.vmap(jm.boundary)(jnp.asarray(m)))


@pytest.mark.parametrize("iterations", [3, 128])
def test_label_blobs(iterations):
    m = _masks()
    _eq(tm.label_blobs(_t(m), iterations),
        jax.vmap(lambda x: jm.label_blobs(x, iterations))(jnp.asarray(m)))


@pytest.mark.parametrize("downsample", [1, 4])
def test_top_blobs_with_tied_areas(downsample):
    m = _masks()
    blobs, valid = tm.top_blobs(_t(m), 4, 10.0, downsample=downsample)
    jb, jv = jax.vmap(lambda x: jm.top_blobs(x, 4, 10.0, downsample=downsample))(
        jnp.asarray(m))
    _eq(blobs, jb)
    _eq(valid, jv)
    assert valid[0, :2].all()


def test_centroid_snap_bbox():
    m = _masks()
    c, ok = tm.mask_centroid(_t(m))
    jc, jok = jax.vmap(jm.mask_centroid)(jnp.asarray(m))
    _eq(c, jc)
    _eq(ok, jok)
    pts = np.array([[3.5, 40.0], [31.0, 1.0], [20.0, 20.0], [5.0, 5.0]], np.float32)
    _eq(tm.snap_into_mask(_t(pts), _t(m)),
        jax.vmap(jm.snap_into_mask)(jnp.asarray(pts), jnp.asarray(m)))
    box, bok = tm.mask_bbox(_t(m))
    jbox, jbok = jax.vmap(jm.mask_bbox)(jnp.asarray(m))
    _eq(box, jbox)
    _eq(bok, jbok)


@pytest.mark.parametrize("farthest,n", [(False, 5), (True, 12)])
def test_angular_boundary_points(farthest, n):
    m = _masks()
    c = jax.vmap(lambda x: jm.snap_into_mask(jm.mask_centroid(x)[0], x))(jnp.asarray(m))
    pts, ok = tm.angular_boundary_points(_t(m), _t(np.asarray(c)), n, farthest)
    jpts, jok = jax.vmap(lambda x, cc: jm.angular_boundary_points(x, cc, n, farthest))(
        jnp.asarray(m), c)
    _eq(pts, jpts)
    _eq(ok, jok)


def test_skeleton_keypoints_select_dedup():
    m = _masks()
    skel = tm.skeletonize(_t(m), 48)
    jskel = jax.vmap(lambda x: jm.skeletonize(x, 48))(jnp.asarray(m))
    _eq(skel, jskel)
    ends, br = tm.skeleton_keypoints(skel)
    jends, jbr = jax.vmap(jm.skeleton_keypoints)(jskel)
    _eq(ends, jends)
    _eq(br, jbr)
    score = ends.float() * 3 + br.float() * 2 + skel.float()
    pts, ok = tm.select_mask_points(score, 16)
    jpts, jok = jax.vmap(lambda s: jm.select_mask_points(s, 16))(jnp.asarray(score.numpy()))
    _eq(pts, jpts)
    _eq(ok, jok)
    keep = tm.dedup_points(pts, ok, 5.0)
    _eq(keep, jax.vmap(lambda p, v: jm.dedup_points(p, v, 5.0))(jpts, jok))


@pytest.mark.parametrize("mode,alg", list(itertools.product(REFINEMENT_MODES, ("C", "CP", "CPS"))))
def test_build_prompt_pack(mode, alg):
    m = _masks().astype(np.float32)
    valid = np.array([True, True, True, False])
    cfg = RefinementConfig(mode=mode, point_algorithm=alg, **RCFG)
    jcfg = JRefinementConfig(mode=mode, point_algorithm=alg, **RCFG)
    # two frames in one batch: the masks and their mirror image
    m2 = np.stack([m, m[:, ::-1, ::-1]])
    pack = tp.build_prompt_pack(mode, _t(m2), _t(np.stack([valid, valid])), cfg)
    for f in range(2):
        ref = jp.build_prompt_pack(mode, jnp.asarray(m2[f]), jnp.asarray(valid), jcfg)
        assert pack.use_mask == ref.use_mask
        _eq(pack.coords[f], ref.coords)
        _eq(pack.labels[f], ref.labels)
        _eq(pack.has_prompt[f], ref.has_prompt)
    assert not pack.has_prompt[:, 3].any()
