"""Parity of the port's Schur-LM bundle adjuster with the JAX solver on
identical float32 problems (the ``make_problem`` fixture of
``test_bundle_adjust.py``): final cost within 1e-3 relative, points and
poses within 1e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu.config import SolverConfig as JaxSolverConfig
from meatmodeler_tpu.geometry import projection as jproj
from meatmodeler_tpu.solvers import bundle_adjust as jba
from meatmodeler_tpu_torch.solvers import bundle_adjust as tba
from meatmodeler_tpu_torch.testing import f32, from_fields, tt
from test_bundle_adjust import make_problem

torch.set_num_threads(2)


@pytest.mark.parametrize("weighted", [False, True])
def test_adjust_points_matches_jax(weighted):
    K, _, pts, cams0, pts0, obs, fidx, pidx = make_problem(n_frames=8, n_points=150, seed=3)
    ext0 = f32(np.asarray(jproj.extrinsics_from_params(jnp.asarray(f32(cams0)))))
    w = f32(1.0 / 1.2 ** (np.arange(len(obs)) % 3)) if weighted else None
    jp, je, jr = jba.adjust_points(
        jnp.asarray(ext0), jnp.asarray(f32(K)), jnp.asarray(f32(pts0)), jnp.asarray(f32(obs)),
        fidx, pidx, weights=None if w is None else jnp.asarray(w),
    )
    tp, te, tr = tba.adjust_points(
        tt(ext0), tt(K), tt(pts0), tt(obs), fidx, pidx, weights=None if w is None else tt(w),
    )
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)
    np.testing.assert_allclose(float(tr.rmse), float(jr.rmse), rtol=1e-3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-3)
    assert float(tr.rmse) < 1.0


def test_adjust_points_mask_drops_observations():
    K, _, _, cams0, pts0, obs, fidx, pidx = make_problem(n_frames=6, n_points=80, seed=4)
    ext0 = f32(np.asarray(jproj.extrinsics_from_params(jnp.asarray(f32(cams0)))))
    mask = np.arange(len(obs)) % 5 != 0
    _, _, jr = jba.adjust_points(
        jnp.asarray(ext0), jnp.asarray(f32(K)), jnp.asarray(f32(pts0)), jnp.asarray(f32(obs)),
        fidx, pidx, mask=jnp.asarray(mask),
    )
    _, _, tr = tba.adjust_points(tt(ext0), tt(K), tt(pts0), tt(obs), fidx, pidx, mask=tt(mask))
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)


def test_adjust_pose_matches_jax():
    """Pose-only BA against the X-Z board: F independent 6-dof solves."""
    rng = np.random.default_rng(5)
    K = f32([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    board = np.asarray(jba._chessboard_xz((4, 3), 2.0, jnp.float32))
    cams = []
    for i in range(5):
        a = 0.5 * (i / 4 - 0.5)
        rvec = np.array([-1.2 + 0.05 * rng.normal(), a, 0.02 * rng.normal()])
        cams.append(np.r_[rvec, [-3.0, 1.0, 14.0 + rng.normal()]])
    cams = f32(np.stack(cams))
    obs = np.asarray(jproj.project_points(jnp.asarray(board)[None], jnp.asarray(cams)[:, None], jnp.asarray(K)))
    obs = f32(obs + rng.normal(scale=0.3, size=obs.shape)).reshape(-1, 2)
    ext0 = f32(np.asarray(jproj.extrinsics_from_params(jnp.asarray(cams + f32(rng.normal(scale=0.02, size=cams.shape))))))
    cfg = JaxSolverConfig(ftol=1e-7, max_iters=100)
    je, jr = jba.adjust_pose(jnp.asarray(ext0), jnp.asarray(K), jnp.asarray(obs), config=cfg)
    te, tr = tba.adjust_pose(tt(ext0), tt(K), tt(obs), config=from_fields(cfg))
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-3)


def test_point_sharding_is_refused():
    """The memory band refuses, with the JAX package's text, a problem whose
    Schur strip needs more point shards than there are devices: here one
    (the problem's CPU), and 2 shards of the bucket-padded 256 x 4 strip
    (147 456 B) against a 100 000 B budget."""
    K, _, _, cams0, pts0, obs, fidx, pidx = make_problem(n_frames=4, n_points=20, seed=6)
    ext0 = f32(np.asarray(jproj.extrinsics_from_params(jnp.asarray(f32(cams0)))))
    cfg = from_fields(JaxSolverConfig(hbm_strip_budget_bytes=100_000))
    with pytest.raises(ValueError, match="memory band") as err:
        tba.adjust_points(tt(ext0), tt(K), tt(pts0), tt(obs), fidx, pidx, config=cfg)
    assert "needing 2 point shards" in str(err.value) and "only 1 devices" in str(err.value)


@pytest.mark.parametrize(
    "fields", [{"point_shard_devices": 2}, {"point_shard_devices": 4}, {"hbm_strip_budget_bytes": 60_000}],
    ids=["opt-in-2", "opt-in-4", "band-3"],
)
def test_point_sharding_matches_jax(fields):
    """Opted in, or banded (the 147 456 B strip needs 3 shards at 60 000 B),
    the port shards the points over virtual CPU shards and lands where the
    JAX package's one-device solve does: rmse within 1e-4 relative, points
    within 5e-3 (test_sharding.py's bounds: both stop at ftol 1e-4)."""
    K, _, _, cams0, pts0, obs, fidx, pidx = make_problem(n_frames=4, n_points=20, seed=6)
    ext0 = f32(np.asarray(jproj.extrinsics_from_params(jnp.asarray(f32(cams0)))))
    jp, _, jr = jba.adjust_points(jnp.asarray(ext0), jnp.asarray(f32(K)), jnp.asarray(f32(pts0)), jnp.asarray(f32(obs)), fidx, pidx)
    tp, _, tr = tba.adjust_points(
        tt(ext0), tt(K), tt(pts0), tt(obs), fidx, pidx, config=from_fields(JaxSolverConfig(**fields)), devices=["cpu"] * 4
    )
    np.testing.assert_allclose(float(tr.rmse), float(jr.rmse), rtol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=5e-3)
