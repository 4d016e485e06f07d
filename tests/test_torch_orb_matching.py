"""ORB and Hamming matching in the port against the JAX package.

On a CLAHE'd synthetic frame, >= 99% of the keypoint slots (validity,
position, octave) must be identical and the descriptors bit-identical where
the keypoints are: the port keeps the reference's sampling pattern, 30-bin
angle quantisation and bfloat16 sampling arithmetic. Matching is exactly
equal on identical descriptors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu.ops import matching as jmatch
from meatmodeler_tpu.ops import orb as jorb
from meatmodeler_tpu.ops.clahe import clahe_xla
from meatmodeler_tpu_torch.ops import matching as tmatch
from meatmodeler_tpu_torch.ops import orb as torb
from meatmodeler_tpu_torch.testing import tt

torch.set_num_threads(2)

ORB_KW = dict(max_features=1024, num_levels=3)


@pytest.fixture(scope="module")
def frames():
    scene = TurntableScene(image_size=(320, 240), focal=336.0, noise_sigma=1.0)
    raw, _, _ = render_sequence(scene, 12, seed=0, color=False)
    return np.asarray(clahe_xla(jnp.asarray(raw.astype(np.float32))), np.float32)


@pytest.fixture(scope="module")
def features(frames):
    jax_feats = [jorb.detect_and_compute(jnp.asarray(g), **ORB_KW) for g in frames[:2]]
    torch_feats = torb.detect_and_compute(tt(frames[:2]), **ORB_KW)
    return jax_feats, torch_feats


def test_brief_pattern_is_the_references():
    np.testing.assert_array_equal(torb._make_brief_pattern(), jorb._make_brief_pattern())


def test_fast_score_matches(frames):
    ref = np.asarray(jorb.fast_score(jnp.asarray(frames[0]), 20.0))
    np.testing.assert_array_equal(torb.fast_score(tt(frames[:1]), 20.0)[0].numpy(), ref)


def test_gauss7_matches(frames):
    ref = np.asarray(jorb._gauss7(jnp.asarray(frames[0])))
    np.testing.assert_allclose(torb._gauss7(tt(frames[:1]))[0].numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("i", [0, 1])
def test_detect_and_compute_matches(features, i):
    jf, tf = features[0][i], [x[i].numpy() for x in features[1]]
    t_xy, t_resp, t_angle, t_oct, t_desc, t_mask = tf
    j_mask, j_xy = np.asarray(jf.mask), np.asarray(jf.xy)
    same = (j_mask == t_mask) & (~j_mask | np.all(j_xy == t_xy, axis=1))
    same &= np.asarray(jf.octave) == t_oct
    assert same.mean() >= 0.99, same.mean()
    assert j_mask.sum() > 200
    both = same & j_mask
    np.testing.assert_array_equal(t_desc[both], np.asarray(jf.descriptors)[both])
    np.testing.assert_allclose(t_angle[both], np.asarray(jf.angle)[both], atol=1e-4)
    np.testing.assert_allclose(t_resp[both], np.asarray(jf.response)[both], rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("grid", [2, 4])
def test_grid_cells_selection_matches(frames, grid):
    """``grid_cells`` bucketed selection (the reference's ``approx_max_k``
    is an exact sort on the CPU): keypoints, octaves and descriptors equal
    to the JAX package's slot for slot, two images in one batch, one of
    them with a height that does not divide by the grid."""
    imgs = [frames[0], frames[1][:-3]]
    for img in imgs:
        jf = jorb.detect_and_compute(jnp.asarray(img), grid_cells=grid, **ORB_KW)
        tf = torb.detect_and_compute(tt(img[None]), grid_cells=grid, **ORB_KW)
        t_mask = tf.mask[0].numpy()
        np.testing.assert_array_equal(t_mask, np.asarray(jf.mask))
        assert t_mask.sum() > 200
        np.testing.assert_array_equal(tf.xy[0].numpy()[t_mask], np.asarray(jf.xy)[t_mask])
        np.testing.assert_array_equal(tf.octave[0].numpy(), np.asarray(jf.octave))
        np.testing.assert_array_equal(tf.descriptors[0].numpy()[t_mask], np.asarray(jf.descriptors)[t_mask])
    # Bucketing changes the selection (it is not the global top-k).
    flat = torb.detect_and_compute(tt(frames[:1]), **ORB_KW)
    bucketed = torb.detect_and_compute(tt(frames[:1]), grid_cells=grid, **ORB_KW)
    assert not torch.equal(flat.xy[flat.mask], bucketed.xy[bucketed.mask])


def _match_both(dq, dt, mq, mt, **kw):
    j = jmatch.match_descriptors(jnp.asarray(dq), jnp.asarray(dt), jnp.asarray(mq), jnp.asarray(mt), **kw)
    t = tmatch.match_descriptors(tt(dq), tt(dt), tt(mq), tt(mt), **kw)
    return j, t


def _assert_same_matches(j, t):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    m = np.asarray(j.mask)
    np.testing.assert_array_equal(t.query_idx.numpy()[m], np.asarray(j.query_idx)[m])
    np.testing.assert_array_equal(t.train_idx.numpy()[m], np.asarray(j.train_idx)[m])
    np.testing.assert_array_equal(t.distance.numpy(), np.asarray(j.distance))


def test_match_descriptors_on_orb_features(features):
    jf = features[0]
    kw = dict(ratio=0.75, max_distance=96, max_matches=512, cross_check=True)
    args = [np.asarray(x) for x in (jf[0].descriptors, jf[1].descriptors, jf[0].mask, jf[1].mask)]
    j, t = _match_both(*args, **kw)
    assert int(np.asarray(j.mask).sum()) > 50
    _assert_same_matches(j, t)


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_descriptors_ties(cross_check):
    """Integer distances tie often: the kept set and its order must follow
    lax.top_k's lower-index-first rule."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 2, size=(40, 256), dtype=np.int8)
    dq = np.concatenate([base, base[:10]])  # duplicate rows -> exact ties
    dt = base[rng.permutation(40)].copy()
    dt[:, :3] ^= 1
    mq = rng.random(50) < 0.9
    mt = rng.random(40) < 0.9
    j, t = _match_both(dq, dt, mq, mt, ratio=0.9, max_distance=256, max_matches=16, cross_check=cross_check)
    _assert_same_matches(j, t)


def test_hamming_matrix_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2, size=(30, 256), dtype=np.int8)
    b = rng.integers(0, 2, size=(20, 256), dtype=np.int8)
    ref = (a[:, None, :] != b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(tmatch.hamming_matrix(tt(a), tt(b)).numpy(), ref)


@pytest.mark.parametrize("block", [1, 2, 5])
def test_match_descriptors_in_pair_blocks(monkeypatch, block):
    """A stack of keyframe pairs matched in blocks of ``block`` pairs (the
    distance budget ``_BLOCK_ENTRIES`` set to that many pairs' matrices)
    gives exactly the all-at-once result, and that the JAX package's."""
    rng = np.random.default_rng(4)
    dq = rng.integers(0, 2, size=(5, 60, 256), dtype=np.int8)
    dt = dq[:, rng.permutation(60)].copy()
    dt[..., :4] ^= rng.integers(0, 2, size=(5, 60, 4), dtype=np.int8)
    mq, mt = rng.random((5, 60)) < 0.9, rng.random((5, 60)) < 0.9
    kw = dict(ratio=0.8, max_distance=96, max_matches=32, cross_check=True)
    args = [tt(x) for x in (dq, dt, mq, mt)]
    whole = tmatch.match_descriptors(*args, **kw)
    monkeypatch.setattr(tmatch, "_BLOCK_ENTRIES", block * 60 * 60)
    parts = tmatch.match_descriptors(*args, **kw)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    assert int(whole.mask.sum()) > 20
    ref = jax.vmap(lambda *a: jmatch.match_descriptors(*a, **kw))(*(jnp.asarray(x) for x in (dq, dt, mq, mt)))
    _assert_same_matches(ref, parts)
