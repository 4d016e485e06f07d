"""``two_view.reconstruct_two_view`` and ``utils/alignment.py``: the port
against the JAX package on the scene of ``test_two_view.py`` (400x300,
frames 0 and 1 of 8, seed 3; 1536 ORB features on 2 levels, 512 matches),
in float32, with the JAX draws handed to the port through
``ransac.sample_subsets`` (see ``test_torch_ransac.py``).

Tolerances: identical matches; LK-polished points within 1e-3 px; the
essential matrix up to sign within 1e-3; inlier count within 2%; and the
port's result meets ``test_two_view.py::TestTwoViewImages``'s checks.
Alignment: the port's numpy copy equals the JAX package's to 1e-12."""

import jax
import numpy as np
import pytest
import torch

from meatmodeler_tpu.io.synthetic import render_sequence
from meatmodeler_tpu.two_view import reconstruct_two_view as jax_two_view
from meatmodeler_tpu.utils import alignment as jalign
from meatmodeler_tpu_torch.geometry import so3
from meatmodeler_tpu_torch.testing import from_fields
from meatmodeler_tpu_torch.two_view import reconstruct_two_view
from meatmodeler_tpu_torch.utils import alignment as talign
from test_torch_ransac import inject_draws
from test_two_view import CFG, SCENE, _relative_pose

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs():
    frames, poses, _ = render_sequence(SCENE, 8, seed=3)
    res_j = jax_two_view(frames[0], frames[1], SCENE.intrinsics, config=CFG)
    with pytest.MonkeyPatch.context() as mp:
        key = jax.random.PRNGKey(0)
        inject_draws(mp, {8: key, 4: jax.random.fold_in(key, 1)})
        res_t = reconstruct_two_view(frames[0], frames[1], SCENE.intrinsics, config=from_fields(CFG), device="cpu")
    return res_j, res_t, poses


def test_matches_and_polish_agree(runs):
    res_j, res_t, _ = runs
    np.testing.assert_array_equal(res_t.pts1.numpy(), np.asarray(res_j.pts1, np.float32))
    np.testing.assert_allclose(res_t.pts2.numpy(), np.asarray(res_j.pts2), atol=1e-3)


def test_pose_and_inliers_agree(runs):
    res_j, res_t, _ = runs
    e_t, e_j = res_t.essential.numpy().ravel(), np.asarray(res_j.essential).ravel()
    assert min(np.abs(e_t - e_j).max(), np.abs(e_t + e_j).max()) <= 1e-3
    np.testing.assert_allclose(res_t.rvec.numpy(), np.asarray(res_j.rvec), atol=1e-3)
    np.testing.assert_allclose(res_t.tvec.numpy(), np.asarray(res_j.tvec), atol=1e-3)
    n_j = int(res_j.num_inliers)
    assert abs(int(res_t.num_inliers) - n_j) <= 0.02 * n_j


def test_two_view_checks(runs):
    """``test_two_view.py::TestTwoViewImages`` on the port's result."""
    _, res, poses = runs
    assert int(res.num_inliers) > 30
    inl = res.inliers.numpy()
    k = SCENE.intrinsics
    n1 = (res.pts1.numpy() - k[:2, 2]) / [k[0, 0], k[1, 1]]
    n2 = (res.pts2.numpy() - k[:2, 2]) / [k[0, 0], k[1, 1]]
    x1 = np.hstack([n1, np.ones((len(n1), 1))])
    x2 = np.hstack([n2, np.ones((len(n2), 1))])
    e = res.essential.numpy().astype(np.float64)
    ex1, etx2 = x1 @ e.T, x2 @ e
    d2 = np.sum(x2 * ex1, 1) ** 2 / np.maximum(ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2, 1e-12)
    assert np.median(np.sqrt(d2[inl]) * SCENE.focal) < 1.0
    r_rel, _ = _relative_pose(poses[0], poses[1])
    r_est = so3.exp(res.rvec.to(torch.float64)).numpy()
    angle_err = np.degrees(np.arccos(np.clip((np.trace(r_est @ r_rel.T) - 1.0) / 2.0, -1.0, 1.0)))
    assert angle_err < 45.0
    pts = res.points.numpy()[inl]
    assert (pts[:, 2] > 0).all() and np.isfinite(pts).all()


def test_tf32_restored_and_cuda_default():
    """An entry point of its own: full float32 inside, the caller's TF32
    settings back afterwards, also when it raises; "cuda" by default, which
    raises without a card."""
    frames, _, _ = render_sequence(SCENE, 2, seed=3)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(Exception):
            reconstruct_two_view(frames[0], frames[1][:10], SCENE.intrinsics, config=from_fields(CFG), device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reconstruct_two_view(frames[0], frames[1], SCENE.intrinsics)


@pytest.mark.parametrize("with_scale", [True, False])
def test_alignment_matches_jax_package(with_scale):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    dst = 2.37 * src @ (q * np.sign(np.linalg.det(q))).T + [1.0, -2.0, 0.5] + rng.normal(scale=0.01, size=src.shape)
    tj, tt_ = jalign.umeyama(src, dst, with_scale), talign.umeyama(src, dst, with_scale)
    assert abs(tt_.scale - tj.scale) <= 1e-12
    np.testing.assert_allclose(tt_.rotation, tj.rotation, atol=1e-12)
    np.testing.assert_allclose(tt_.translation, tj.translation, atol=1e-12)
    np.testing.assert_allclose(tt_.apply(src), tj.apply(src), atol=1e-12)
    assert abs(talign.aligned_rmse(src, dst, with_scale) - jalign.aligned_rmse(src, dst, with_scale)) <= 1e-12
    with pytest.raises(ValueError):
        talign.umeyama(src[:2], dst[:2])
