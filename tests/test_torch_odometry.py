"""``odometry.chain_poses`` of the port against the JAX package's on the
scene of ``test_odometry.py``. The JAX function draws each step's RANSAC
hypotheses from ``fold_in(PRNGKey(0), t)`` (its homography from
``fold_in(that key, 1)``); the parity test hands the port those draws
through ``ransac.sample_subsets``. Tolerances: the same tracked and inlier
counts, rotations within 2e-3 rad, per-step scales within 1e-3 relative.
Unpatched, the port's own ``torch.Generator`` draws are held to the
renderer's orbit with the checks of ``test_odometry.py``."""

import jax
import numpy as np
import pytest
import torch

from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu.odometry import chain_poses as jax_chain_poses
from meatmodeler_tpu_torch.geometry import ransac as tr
from meatmodeler_tpu_torch.geometry import so3
from meatmodeler_tpu_torch.odometry import chain_poses
from test_torch_ransac import jax_draws

torch.set_num_threads(2)

SCENE = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=0.5)


def _rotations(poses):
    return so3.exp(torch.from_numpy(np.asarray(poses, np.float32)[:, :3])).numpy().astype(np.float64)


def _angles_deg(r_a, r_b):
    cos = (np.einsum("tij,tij->t", r_a, r_b) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


@pytest.fixture(scope="module")
def frames():
    f, gt, _ = render_sequence(SCENE, 10, seed=3)
    return f, gt


def test_chain_poses_matches_jax(frames, monkeypatch):
    f = frames[0][:4]
    step = {"t": 0}

    def fake(mask, num_hypotheses, size, generator):
        if size == 8:  # each step draws its essential hypotheses first
            step["t"] += 1
        key = jax.random.fold_in(jax.random.PRNGKey(0), step["t"])
        if size == 4:
            key = jax.random.fold_in(key, 1)
        return torch.from_numpy(jax_draws(mask.cpu().numpy(), key, num_hypotheses, size).astype(np.int64))

    jres = jax_chain_poses(f, SCENE.intrinsics)
    monkeypatch.setattr(tr, "sample_subsets", fake)
    tres = chain_poses(f, SCENE.intrinsics, device="cpu")
    assert step["t"] == len(f) - 1
    np.testing.assert_array_equal(tres.num_tracked, jres.num_tracked)
    np.testing.assert_array_equal(tres.num_inliers, jres.num_inliers)
    assert (tres.num_tracked[1:] > 50).all()
    rot_err = np.radians(_angles_deg(_rotations(tres.poses), _rotations(jres.poses)))
    assert rot_err.max() < 2e-3, rot_err
    np.testing.assert_allclose(tres.scales[1:], jres.scales[1:], rtol=1e-3)
    assert tres.poses.shape == (len(f), 6) and tres.poses.dtype == np.float32


def test_chain_poses_follows_the_orbit(frames):
    """The port's own draws: tracks survive and the chained rotations follow
    the ground-truth orbit (``test_odometry.py``'s bounds)."""
    f, gt = frames
    res = chain_poses(f, SCENE.intrinsics, generator=torch.Generator().manual_seed(5), device="cpu")
    assert (res.num_tracked[1:] > 50).all(), res.num_tracked
    assert (res.num_inliers[1:] > 30).all(), res.num_inliers
    r_est, r_gt = _rotations(res.poses), _rotations(gt)
    rel_est = np.einsum("tij,kj->tik", r_est, r_est[0])
    rel_gt = np.einsum("tij,kj->tik", r_gt, r_gt[0])
    assert _angles_deg(rel_est, rel_gt).max() < 6.0
    steps = np.asarray(res.scales[1:])
    assert steps.std() / steps.mean() < 0.35, steps


def test_chain_poses_reseeds_below_min_tracks(frames):
    """With ``min_tracks`` above the live count every step reseeds, so no
    slot carries a depth into the next step and the scale stays at the
    first step's."""
    res = chain_poses(frames[0][:4], SCENE.intrinsics, min_tracks=10_000, device="cpu")
    np.testing.assert_array_equal(res.scales[1:], np.ones(3, np.float32))


def test_chain_poses_needs_a_card_by_default(frames, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chain_poses(frames[0][:2], SCENE.intrinsics)
