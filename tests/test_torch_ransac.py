"""``geometry/ransac.py``: the port against the JAX package on the scenes of
``test_ransac.py`` and ``test_two_view.py``, in float32, with the SAME
hypotheses. JAX's threefry draws cannot be reproduced in torch, so each test
computes the draws the JAX function makes (``jax.random.categorical`` over
the masked logit row; ``fold_in(key, 1)`` for the homography inside
``estimate_relative_pose``) and hands them to the port through
``ransac.sample_subsets`` with ``monkeypatch``.

Tolerances (float32 on both sides; eigen/SVD solves in two LAPACK builds):
matrices up to sign and scale within 1e-3 relative; inlier masks equal but
for at most 1% of the points; poses within 1e-3 in rvec and unit tvec.
One test uses the port's own ``torch.Generator`` draws and holds the pose
to ground truth with the checks of ``test_two_view.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meatmodeler_tpu.geometry import ransac as jr
from meatmodeler_tpu.geometry import so3 as jso3
from meatmodeler_tpu_torch.geometry import ransac as tr
from meatmodeler_tpu_torch.testing import f32, tt
from test_ransac import two_view_scene
from test_two_view import TestEstimateRelativePoseWellPosed, _relative_pose

torch.set_num_threads(2)


def jax_draws(mask: np.ndarray, key, num_hypotheses: int, size: int) -> np.ndarray:
    """The indices the JAX functions draw: the same expression they run."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
    return np.asarray(jax.random.categorical(key, logits[None, :], shape=(num_hypotheses, size)))


def inject_draws(monkeypatch, keys):
    """Route the port's draws to JAX's: ``keys`` maps the subset size (8 for
    F/E hypotheses, 4 for homographies) to the JAX key of that draw."""

    def fake(mask, num_hypotheses, size, generator):
        idx = jax_draws(mask.cpu().numpy(), keys[size], num_hypotheses, size)
        return torch.from_numpy(idx.astype(np.int64)).to(mask.device)

    monkeypatch.setattr(tr, "sample_subsets", fake)


def _scene(seed, outlier_frac=0.3):
    k, rvec, tvec, p1, p2, gt_in = two_view_scene(outlier_frac=outlier_frac, seed=seed)
    return f32(k), rvec, tvec, f32(p1), f32(p2), gt_in


def _same_up_to_scale(a, b, tol=1e-3):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) <= tol, (a, b)


def _masks_agree(a, b, frac=0.01):
    a, b = np.asarray(a), np.asarray(b)
    assert (a != b).sum() <= max(1, frac * a.size), ((a != b).sum(), a.sum(), b.sum())


def test_sample_subsets_draws_valid_entries_uniformly():
    """Only valid entries, every one of them, about equally often."""
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    idx = tr.sample_subsets(mask, 4000, 8, torch.Generator().manual_seed(1))
    assert idx.shape == (4000, 8) and idx.dtype == torch.int64
    assert bool(mask[idx].all())
    counts = torch.bincount(idx.ravel(), minlength=50)[mask]
    assert int(counts.min()) > 0.8 * 32000 / 17 and int(counts.max()) < 1.2 * 32000 / 17
    empty = tr.sample_subsets(torch.zeros(5, dtype=torch.bool), 3, 4, torch.Generator().manual_seed(1))
    assert bool((empty == 4).all())


def test_normalize_and_eight_point():
    """Hartley normalization and one batched 8-point solve (rank 2, equal to
    JAX's up to sign and scale)."""
    k, _, _, p1, p2, _ = _scene(0)
    mask = np.ones(len(p1), bool)
    mask[::7] = False
    nj, tj = jr._normalize(jnp.asarray(p1), jnp.asarray(mask))
    nt, tt_ = tr._normalize(tt(p1), tt(mask))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt_.numpy(), np.asarray(tj), rtol=1e-5, atol=1e-5)
    n2j, _ = jr._normalize(jnp.asarray(p2), jnp.asarray(mask))
    sel = np.arange(0, 80, 10)
    fj = np.asarray(jr._eight_point(nj[sel], n2j[sel]))
    ft = tr._eight_point(nt[sel][None], tt(np.asarray(n2j)[sel])[None])[0].numpy()
    _same_up_to_scale(ft, fj)
    assert np.linalg.matrix_rank(ft, tol=1e-6 * np.abs(ft).max()) == 2


def test_sampson_and_project_to_essential():
    k, rvec, tvec, p1, p2, _ = _scene(1)
    f = f32(np.random.default_rng(0).normal(size=(3, 3)))
    p1h = np.hstack([p1, np.ones((len(p1), 1), np.float32)])
    p2h = np.hstack([p2, np.ones((len(p2), 1), np.float32)])
    np.testing.assert_allclose(
        tr._sampson(tt(f), tt(p1h), tt(p2h)).numpy(),
        np.asarray(jr._sampson(jnp.asarray(f), jnp.asarray(p1h), jnp.asarray(p2h))), rtol=1e-4,
    )
    ej = np.asarray(jr._project_to_essential(jnp.asarray(f)))
    et = tr._project_to_essential(tt(f)).numpy()
    _same_up_to_scale(et, ej, tol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_find_fundamental(monkeypatch, seed):
    """Same draws -> same F (up to sign and scale), inliers and residuals."""
    k, _, _, p1, p2, gt_in = _scene(seed)
    mask = np.ones(len(p1), bool)
    key = jax.random.PRNGKey(seed)
    inject_draws(monkeypatch, {8: key})
    rj = jr.find_fundamental(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), key, threshold=2.0)
    rt = tr.find_fundamental(tt(p1), tt(p2), tt(mask), threshold=2.0)
    _same_up_to_scale(rt.matrix.numpy(), np.asarray(rj.matrix))
    _masks_agree(rt.inliers.numpy(), np.asarray(rj.inliers))
    found = rt.inliers.numpy()
    assert found[gt_in].mean() > 0.9 and found[~gt_in].mean() < 0.1


def test_find_essential_and_recover_pose(monkeypatch):
    """Same draws -> same E, inliers, and the pose ``recover_pose`` votes for
    (which also matches ground truth, the checks of ``test_ransac.py``)."""
    k, rvec, tvec, p1, p2, _ = _scene(2, outlier_frac=0.2)
    mask = np.ones(len(p1), bool)
    key = jax.random.PRNGKey(2)
    inject_draws(monkeypatch, {8: key})
    rj = jr.find_essential(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), jnp.asarray(k), key, threshold=2.0)
    rt = tr.find_essential(tt(p1), tt(p2), tt(mask), tt(k), threshold=2.0)
    _same_up_to_scale(rt.matrix.numpy(), np.asarray(rj.matrix))
    _masks_agree(rt.inliers.numpy(), np.asarray(rj.inliers))

    e = np.asarray(rj.matrix)
    inl = np.asarray(rj.inliers)
    rvj, tvj, votes_j = jr.recover_pose(jnp.asarray(e), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(inl), jnp.asarray(k))
    rvt, tvt, votes_t = tr.recover_pose(tt(e), tt(p1), tt(p2), tt(inl), tt(k))
    np.testing.assert_allclose(rvt.numpy(), np.asarray(rvj), atol=1e-4)
    np.testing.assert_allclose(tvt.numpy(), np.asarray(tvj), atol=1e-4)
    assert sorted(votes_t.tolist()) == sorted(np.asarray(votes_j).tolist())
    dr = np.asarray(jso3.log(jso3.exp(jnp.asarray(rvt.numpy())) @ jso3.exp(jnp.asarray(rvec, jnp.float32)).T))
    assert np.linalg.norm(dr) < np.deg2rad(1.5)
    assert abs(np.dot(tvt.numpy(), tvec / np.linalg.norm(tvec))) > 0.99


def test_triangulate_midpoint():
    rng = np.random.default_rng(3)
    rot = np.asarray(jso3.exp(jnp.asarray([0.02, 0.2, -0.05], jnp.float32)))
    t = f32([-0.9, 0.1, 0.2])
    n1, n2 = f32(rng.normal(size=(40, 2)) * 0.2), f32(rng.normal(size=(40, 2)) * 0.2)
    xj, z1j, z2j = jr._triangulate_midpoint(jnp.asarray(rot), jnp.asarray(t), jnp.asarray(n1), jnp.asarray(n2))
    xt, z1t, z2t = tr._triangulate_midpoint(tt(rot), tt(t), tt(n1), tt(n2))
    for a, b in ((xt, xj), (z1t, z1j), (z2t, z2j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_refine_relative_pose():
    """15 robust GN steps from a perturbed pose, batched over two starts
    (each equal to JAX's single-start result)."""
    k, rvec, tvec, p1, p2, _ = _scene(4, outlier_frac=0.2)
    mask = np.ones(len(p1), bool)
    starts = f32([np.r_[rvec + 0.01, tvec / np.linalg.norm(tvec) + 0.05], np.r_[rvec - 0.02, tvec / np.linalg.norm(tvec)]])
    rvt, tvt = tr.refine_relative_pose(tt(starts[:, :3]), tt(starts[:, 3:]), tt(p1), tt(p2), tt(mask), tt(k))
    for b in range(2):
        rvj, tvj = jr.refine_relative_pose(
            jnp.asarray(starts[b, :3]), jnp.asarray(starts[b, 3:]), jnp.asarray(p1), jnp.asarray(p2),
            jnp.asarray(mask), jnp.asarray(k),
        )
        np.testing.assert_allclose(rvt[b].numpy(), np.asarray(rvj), atol=1e-4)
        np.testing.assert_allclose(tvt[b].numpy(), np.asarray(tvj), atol=1e-4)


def test_homography_ransac_and_decomposition(monkeypatch):
    """Same 4-point draws -> same H and inliers on a planar scene; the 8
    Faugeras candidates equal JAX's as a set."""
    rng = np.random.default_rng(5)
    k = f32([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
    plane = np.c_[rng.uniform(-2, 2, (200, 2)), np.full(200, 8.0)]
    rot = np.asarray(jso3.exp(jnp.asarray([0.03, 0.15, 0.01])), np.float64)
    cam = plane @ rot.T + [-1.0, 0.1, 0.2]
    x1 = plane @ k.T
    x2 = cam @ k.T
    p1 = f32(x1[:, :2] / x1[:, 2:] + rng.normal(scale=0.3, size=(200, 2)))
    p2 = f32(x2[:, :2] / x2[:, 2:] + rng.normal(scale=0.3, size=(200, 2)))
    p2[:30] = f32(rng.uniform([0, 0], [640, 480], size=(30, 2)))
    mask = np.ones(200, bool)
    key = jax.random.PRNGKey(7)
    inject_draws(monkeypatch, {4: key})
    hj = jr.find_homography_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), key)
    ht = tr.find_homography_ransac(tt(p1), tt(p2), tt(mask))
    # The polish solves the DLT in raw pixels, where float32 eigenvectors
    # of two LAPACK builds differ in the matrix's small entries; compare
    # what H does to the inliers instead: mapped points within 0.05 px.
    inl = np.asarray(hj.inliers)
    q = np.c_[p1, np.ones(200, np.float32)][inl]
    mt, mj = q @ ht.matrix.numpy().T, q @ np.asarray(hj.matrix).T
    assert np.abs(mt[:, :2] / mt[:, 2:] - mj[:, :2] / mj[:, 2:]).max() <= 0.05
    _masks_agree(ht.inliers.numpy(), inl)
    assert ht.inliers[:30].sum() <= 2

    h = np.asarray(hj.matrix)
    rj, tj = (np.asarray(a) for a in jr._decompose_homography(jnp.asarray(h), jnp.asarray(k)))
    rt, tt2 = (a.numpy() for a in tr._decompose_homography(tt(h), tt(k)))
    cj = np.concatenate([rj, tj], 1)
    ct = np.concatenate([rt, tt2], 1)
    for row in ct:
        assert np.abs(cj - row).max(axis=1).min() <= 1e-3, row


class TestEstimateRelativePose:
    """The LO-RANSAC bootstrap the marker-free chain runs."""

    def _check_parity(self, monkeypatch, x1, x2, k, mask, key):
        inject_draws(monkeypatch, {8: key, 4: jax.random.fold_in(key, 1)})
        rvj, tvj, rj = jr.estimate_relative_pose(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), jnp.asarray(k), key)
        rvt, tvt, rt = tr.estimate_relative_pose(tt(x1), tt(x2), tt(mask), tt(k))
        np.testing.assert_allclose(rvt.numpy(), np.asarray(rvj), atol=1e-3)
        np.testing.assert_allclose(tvt.numpy(), np.asarray(tvj), atol=1e-3)
        _masks_agree(rt.inliers.numpy(), np.asarray(rj.inliers))
        return rvt.numpy(), tvt.numpy(), rt

    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_jax_well_posed(self, monkeypatch, seed):
        """The scene of ``test_two_view.py`` (spread structure, 0.5 px)."""
        k, p0, p1, x1, x2 = TestEstimateRelativePoseWellPosed()._scene(noise=0.5, seed=seed)
        mask = np.ones(len(x1), bool)
        mask[-10:] = False  # padded slots
        self._check_parity(monkeypatch, f32(x1), f32(x2), f32(k), mask, jax.random.PRNGKey(seed))

    def test_matches_jax_with_outliers(self, monkeypatch):
        k, rvec, tvec, p1, p2, _ = _scene(3)
        self._check_parity(monkeypatch, p1, p2, k, np.ones(len(p1), bool), jax.random.PRNGKey(3))

    @pytest.mark.parametrize("outliers", [False, True])
    def test_own_draws_recover_the_pose(self, outliers):
        """Unpatched: the port's own generator recovers the truth, with the
        checks of ``test_two_view.py``'s ``test_recovers_pose`` (default
        generator) and ``test_robust_to_outliers`` (generator seed 2). On the
        outlier scene both packages miss on some seeds: 8 and 9 of 30 in a
        sweep of seeds 6-35, so the seed is pinned, as the JAX test's is."""
        k, p0, p1, x1, x2 = TestEstimateRelativePoseWellPosed()._scene(noise=0.5, seed=int(outliers))
        generator = None
        if outliers:
            rng = np.random.default_rng(2)
            out = rng.choice(len(x1), 60, replace=False)
            x2[out] = rng.uniform([0, 0], [400, 300], size=(60, 2))
            generator = torch.Generator().manual_seed(2)
        rv, tv, res = tr.estimate_relative_pose(tt(x1), tt(x2), torch.ones(len(x1), dtype=torch.bool), tt(k), generator)
        r_rel, t_rel = _relative_pose(p0, p1)
        r_est = np.asarray(jso3.exp(jnp.asarray(rv.numpy())))
        rot_err = np.degrees(np.arccos(np.clip((np.trace(r_est @ r_rel.T) - 1.0) / 2.0, -1.0, 1.0)))
        t_err = np.degrees(np.arccos(np.clip(np.dot(t_rel / np.linalg.norm(t_rel), tv.numpy()), -1, 1)))
        if outliers:
            assert rot_err < 2.0 and t_err < 8.0, (rot_err, t_err)
            assert res.inliers.numpy()[out].mean() < 0.15
        else:
            assert rot_err < 1.5 and t_err < 6.0, (rot_err, t_err)
            assert int(res.num_inliers) > 180
