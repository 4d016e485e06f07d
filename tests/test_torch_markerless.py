"""The marker-free slice: the port's solver additions, its keyframe pose chain
and ``process`` on a board-free video, against the JAX package in float32.

Random draws: the port's RANSAC draws go through
``geometry.ransac.sample_subsets``, which the parity tests replace (with
``monkeypatch``) by the draws the JAX functions make from ``PRNGKey(0)`` —
``jax.random.categorical`` over the masked logit row, and ``fold_in(key, 1)``
for the homography — so both sides test the same hypotheses.

On the board-free clip the bootstrap pair's relative pose is chaotic under
float32 rounding, in the JAX package itself: several of its 24 refined
candidates explain every match (128 of 128 triangulated inliers) in
different basins, a repeated or coplanar 8-point draw has a null space of
dimension > 1, and the JAX function's own vmapped run and a per-candidate
run of the same steps pick different winners. So the whole-slice tests
hand the port the JAX bootstrap, computed by the JAX function on the
port's own track store, and hold everything after it (PnP, the in-chain
BA, triangulation, the global BA, the volume) to the JAX run; the port's
``estimate_relative_pose`` is held to JAX's in ``test_torch_ransac.py``
and in the chain test below, on scenes where the result is well-posed.

Tolerances: ``pose_only_refine`` 1e-4 in the pose parameters; the chain's
re-anchored extrinsics 2e-3; the whole slice (the board-free scene of
``test_pipeline.py::TestMarkerFree``: 400x300, 24 frames, seed 3,
``noise_sigma=0.5``, ``keyframe.threshold=0.025``) identical keyframe
indices, bootstrap support within 2, re-anchored chain rotations within
2e-3 and translations within 2e-3 of their length, rmse within 10%, point count within 5%, hull volume within 10%;
incremental BA per-step rmse within 5%, final points within 1e-3."""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meatmodeler_tpu import pipeline as jpipe
from meatmodeler_tpu.config import SolverConfig as JSolverConfig
from meatmodeler_tpu.geometry import ransac as jr
from meatmodeler_tpu.geometry import projection as jproj
from meatmodeler_tpu.io.synthetic import render_sequence
from meatmodeler_tpu.solvers import bundle_adjust as jba
from meatmodeler_tpu.utils import Metrics as JMetrics
from meatmodeler_tpu.utils.checkpoint import StageCheckpointer as JCheckpointer
from meatmodeler_tpu_torch import pipeline as tpipe
from meatmodeler_tpu_torch.geometry import ransac as tr
from meatmodeler_tpu_torch.solvers import bundle_adjust as tba
from meatmodeler_tpu_torch.testing import f32, from_fields, tt
from meatmodeler_tpu_torch.utils import Metrics as TMetrics
from meatmodeler_tpu_torch.utils.checkpoint import StageCheckpointer as TCheckpointer
from test_pipeline import SCENE, TEST_CONFIG

torch.set_num_threads(2)

BOARD_FREE = dataclasses.replace(SCENE, show_board=False, noise_sigma=0.5)
MF_JAX_CONFIG = dataclasses.replace(
    TEST_CONFIG,
    assume_markerless=True,
    pass1_backend="host",
    keyframe=dataclasses.replace(TEST_CONFIG.keyframe, threshold=0.025),
)
MF_CONFIG = from_fields(MF_JAX_CONFIG)
FALLBACK_JAX_CONFIG = dataclasses.replace(
    MF_JAX_CONFIG,
    assume_markerless=False,
    pass1_backend="device",
    board_probe_frames=6,
    chessboard=dataclasses.replace(TEST_CONFIG.chessboard, detector="device"),
)
FALLBACK_CONFIG = from_fields(FALLBACK_JAX_CONFIG)


def _jax_draws(mask, num_hypotheses, size):
    key = jax.random.PRNGKey(0)
    if size == 4:  # the homography's draws inside estimate_relative_pose
        key = jax.random.fold_in(key, 1)
    logits = jnp.where(jnp.asarray(mask.cpu().numpy()), 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits[None, :], shape=(num_hypotheses, size))
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(mask.device)


def _inject(mp):
    mp.setattr(tr, "sample_subsets", lambda mask, h, size, generator: _jax_draws(mask, h, size))


def _inject_bootstrap(mp):
    """The port's chain gets the JAX bootstrap of its own inputs."""

    def jax_bootstrap(pts1, pts2, mask, intrinsics, generator=None):
        rv, tv, res = jr.estimate_relative_pose(
            *(jnp.asarray(t.cpu().numpy()) for t in (pts1, pts2, mask, intrinsics)), jax.random.PRNGKey(0)
        )
        to_t = lambda x: torch.from_numpy(np.array(x)).to(pts1.device)  # noqa: E731
        return to_t(rv), to_t(tv), tr.RansacResult(*(to_t(x) for x in res))

    mp.setattr(tr, "estimate_relative_pose", jax_bootstrap)


def _spy(mp, module, captured, key):
    """Record what ``module._chain_keyframe_poses`` returns."""
    real = module._chain_keyframe_poses

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        captured[key] = (np.asarray(out[0].cpu() if isinstance(out[0], torch.Tensor) else out[0]), list(out[1]))
        return out

    mp.setattr(module, "_chain_keyframe_poses", spy)


@pytest.fixture(scope="module")
def clip():
    frames, poses, _ = render_sequence(BOARD_FREE, 24, seed=3)
    return frames, poses


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    frames, _ = clip
    out = tmp_path_factory.mktemp("markerless")
    chain = {}
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, jpipe, chain, "jax")
        _spy(mp, tpipe, chain, "torch")
        _inject_bootstrap(mp)
        res_j = jpipe.process(frames, config=MF_JAX_CONFIG)
        res_t = tpipe.process(frames, config=MF_CONFIG, device="cpu", checkpoint_dir=str(out / "ckpt"))
    return {"jax": res_j, "torch": res_t, "chain": chain, "out": out}


# --------------------------------------------------------------------------
# Solver additions
# --------------------------------------------------------------------------


def _pose_problem():
    rng = np.random.default_rng(4)
    k = f32([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
    n = 60
    pts = f32(rng.normal(size=(n, 3)) * 2 + [0, 0, 10])
    cam = f32([0.05, -0.1, 0.02, 0.3, -0.2, 1.0])
    obs = f32(np.asarray(jproj.project_points(pts, np.broadcast_to(cam, (n, 6)), k)) + rng.normal(scale=0.5, size=(n, 2)))
    # One start near the optimum, one far from it: they stop after
    # different numbers of iterations.
    starts = f32([cam + 0.002, cam + [0.08, 0.05, -0.06, 0.5, 0.3, -0.4]])
    mask = np.ones((2, n), bool)
    mask[1, :5] = False
    return k, pts, obs, starts, mask


def test_pose_only_refine_per_lane_stopping():
    """Two independent LM solves in one batch: each equals JAX's vmapped
    solve (1e-4) and, exactly, its own single-problem solve, and the two
    stop after different iteration counts."""
    k, pts, obs, starts, mask = _pose_problem()
    jcfg = dataclasses.replace(JSolverConfig(), ftol=1e-8, max_iters=100)
    cfg = from_fields(jcfg)
    n = len(pts)
    pts2, obs2 = np.broadcast_to(pts, (2, n, 3)), np.broadcast_to(obs, (2, n, 2))
    pj = np.asarray(jba.pose_only_refine(
        jnp.asarray(starts), jnp.asarray(pts2), jnp.asarray(k), jnp.asarray(obs2), jnp.asarray(mask), config=jcfg
    ))
    pt = tba.pose_only_refine(tt(starts), tt(pts2), tt(k), tt(obs2), tt(mask), config=cfg).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    iters = []
    for b in range(2):
        single = tba.solve_ba(
            tba.BAProblem(tt(starts[b : b + 1]), tt(pts), tt(k), tt(obs), torch.zeros(n, dtype=torch.int64),
                          torch.arange(n), tt(mask[b])),
            config=cfg, fix_points=True,
        )
        np.testing.assert_array_equal(single.cam_params.numpy()[0], pt[b])
        iters.append(single.iterations)
    assert iters[0] != iters[1], iters


def test_solve_ba_init_lambda():
    """A runtime damping warm start: JAX's and the port's ``solve_ba`` take
    the same ``init_lambda`` and agree on the solution (1e-4) and, two
    iterations in, on the damping they return as ``final_lambda`` (at
    convergence the two trial steps' costs tie to float32 rounding, so the
    exit damping there is not a comparable number)."""
    rng = np.random.default_rng(6)
    k = f32([[300.0, 0, 64], [0, 300.0, 48], [0, 0, 1]])
    pts = f32(rng.normal(size=(40, 3)) * 2.0)
    cams = f32(np.hstack([rng.normal(size=(4, 3)) * 0.05, rng.normal(size=(4, 3))]) + [0, 0, 0, 0, 0, 12])
    fidx = np.repeat(np.arange(4), 40).astype(np.int32)
    pidx = np.tile(np.arange(40), 4).astype(np.int32)
    obs = f32(np.asarray(jproj.project_points(pts[pidx], cams[fidx], k)) + rng.normal(scale=0.3, size=(160, 2)))
    cams0 = f32(cams + rng.normal(size=cams.shape) * 0.01)
    pts0 = f32(pts + 0.05)
    for lam in (1e-5, 0.3):
        jp = jba.BAProblem(jnp.asarray(cams0), jnp.asarray(pts0), jnp.asarray(k), jnp.asarray(obs),
                           jnp.asarray(fidx), jnp.asarray(pidx), jnp.ones(160, bool))
        rj = jba.solve_ba(jp, init_lambda=jnp.asarray(lam, jnp.float32))
        tp = tba.BAProblem(tt(cams0), tt(pts0), tt(k), tt(obs), torch.from_numpy(fidx).long(),
                           torch.from_numpy(pidx).long(), torch.ones(160, dtype=torch.bool))
        rt = tba.solve_ba(tp, init_lambda=torch.tensor(lam))
        np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-4)
        np.testing.assert_allclose(float(rt.rmse), float(rj.rmse), rtol=1e-4)
        two = dataclasses.replace(JSolverConfig(), max_iters=2)
        rj2 = jba.solve_ba(jp, config=two, init_lambda=jnp.asarray(lam, jnp.float32))
        rt2 = tba.solve_ba(tp, config=from_fields(two), init_lambda=torch.tensor(lam))
        assert rt2.iterations == int(rj2.iterations) == 2
        np.testing.assert_allclose(float(rt2.final_lambda), float(rj2.final_lambda), rtol=1e-5)


# --------------------------------------------------------------------------
# The pose chain on one track store
# --------------------------------------------------------------------------


class _Store(NamedTuple):
    coords: object
    obs_mask: object


def _synthetic_store(n_kf=6, n_tracks=400, seed=0):
    """Tracks of the board-free scene's ellipsoid and ground, seen by the
    renderer's cameras of every third frame, each over a run of keyframes."""
    rng = np.random.default_rng(seed)
    _, poses, _ = render_sequence(BOARD_FREE, 3 * n_kf, seed=3)
    poses = poses[::3]
    k = BOARD_FREE.intrinsics
    ctr, ax = np.array(BOARD_FREE.ellipsoid_center), np.array(BOARD_FREE.ellipsoid_axes)
    d = rng.normal(size=(n_tracks, 3))
    pts = ctr + ax * d / np.linalg.norm(d, axis=1, keepdims=True)
    pts[: n_tracks // 4] = np.c_[rng.uniform(-2, 8, n_tracks // 4), np.zeros(n_tracks // 4), rng.uniform(-3, 7, n_tracks // 4)]
    coords = np.stack(
        [np.asarray(jproj.project_points(pts, np.broadcast_to(p, (n_tracks, 6)), k)) for p in poses], axis=1
    ) + rng.normal(scale=0.3, size=(n_tracks, n_kf, 2))
    first = rng.integers(0, n_kf - 1, n_tracks)
    length = rng.integers(2, n_kf + 1, n_tracks)
    f = np.arange(n_kf)
    obs_mask = (f[None] >= first[:, None]) & (f[None] < first[:, None] + length[:, None])
    obs_mask[:60, :3] = True  # enough tracks through the bootstrap pair
    focal = 1.2 * max(BOARD_FREE.image_size)
    w, h = BOARD_FREE.image_size
    intr = f32([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    return f32(np.where(obs_mask[..., None], coords, 0.0)), obs_mask, intr


def test_chain_keyframe_poses(monkeypatch):
    """The same track store through both chains, the JAX one padded to 8
    keyframe columns as its pipeline pads it, the port's with exactly 6:
    equal support counts and re-anchored extrinsics within 2e-3."""
    coords, obs_mask, intr = _synthetic_store()
    n_kf = coords.shape[1]
    pad = 8 - n_kf
    coords_j = np.pad(coords, ((0, 0), (0, pad), (0, 0)))
    mask_j = np.pad(obs_mask, ((0, 0), (0, pad)))
    _inject(monkeypatch)
    ext_j, sup_j = jpipe._chain_keyframe_poses(_Store(jnp.asarray(coords_j), jnp.asarray(mask_j)), jnp.asarray(intr), n_kf)
    ext_t, sup_t = tpipe._chain_keyframe_poses(_Store(tt(coords), tt(obs_mask)), tt(intr), n_kf)
    assert sup_t == sup_j
    assert ext_t.shape == (n_kf, 3, 4)
    np.testing.assert_allclose(ext_t.numpy(), np.asarray(ext_j), atol=2e-3)


def test_chain_without_structure_raises():
    """Fewer than 8 epipolar inliers in the bootstrap pair: the reference's
    ValueError."""
    coords, obs_mask, intr = _synthetic_store()
    obs_mask[:, 1] = False
    obs_mask[:5, :2] = True
    with pytest.raises(ValueError, match="bootstrap failed"):
        tpipe._chain_keyframe_poses(_Store(tt(coords), tt(obs_mask)), tt(intr), coords.shape[1])


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------


def test_same_keyframes_and_bootstrap(runs):
    cj, ct = runs["jax"].metrics["counters"], runs["torch"].metrics["counters"]
    assert ct["markerless"] is True and cj["markerless"] is True
    assert len(cj["keyframe_indices"]) >= 3
    assert ct["keyframe_indices"] == cj["keyframe_indices"]
    assert abs(ct["pose_chain_inliers"][0] - cj["pose_chain_inliers"][0]) <= 2
    assert ct["pose_chain_inliers"] == cj["pose_chain_inliers"]
    assert ct["matches_per_pair"] == cj["matches_per_pair"]


def test_chain_extrinsics_agree(runs):
    """Rotations within 2e-3; translations within 2e-3 of their length: the
    chain's BA leaves the monocular scale free, and the two runs' gauges
    differ by a scale of ~8e-4 (every keyframe's translation by the same
    fraction)."""
    (ext_j, _), (ext_t, _) = runs["chain"]["jax"], runs["chain"]["torch"]
    assert ext_t.shape == ext_j.shape
    np.testing.assert_allclose(ext_t[:, :, :3], ext_j[:, :, :3], atol=2e-3)
    dt = np.linalg.norm(ext_t[:, :, 3] - ext_j[:, :, 3], axis=1)
    assert np.all(dt <= 2e-3 * np.linalg.norm(ext_j[:, :, 3], axis=1) + 1e-6), dt


def test_rmse_points_volume_agree(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t.reprojection_rmse, j.reprojection_rmse, rtol=0.10)
    assert abs(len(t.points) - len(j.points)) <= 0.05 * len(j.points)
    np.testing.assert_allclose(t.volume, j.volume, rtol=0.10)
    np.testing.assert_allclose(t.intrinsics, j.intrinsics, rtol=1e-6)
    assert not t.distortion.any()


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_marker_free_checks(runs, which):
    """``test_pipeline.py::TestMarkerFree::test_assume_markerless_skips_board_hunt``
    and ``test_board_free_video_reconstructs_up_to_scale``'s checks."""
    res = runs[which]
    counters = res.metrics["counters"]
    assert counters.get("markerless") is True
    assert "board_probe_exhausted" not in counters
    assert np.isfinite(res.reprojection_rmse) and res.reprojection_rmse < 2.0
    assert len(res.points) >= 30 and np.isfinite(res.points).all()
    assert np.isfinite(res.volume)


def test_stages_recorded(runs):
    timings = runs["torch"].metrics["timings"]
    assert "pose_chain" in timings
    for stage in ("corner_refine", "calibration", "pose_estimation", "pose_ba"):
        assert stage not in timings


def test_unpatched_port_run(clip, tmp_path):
    """The port's own draws: the checks of ``test_pipeline.py::TestMarkerFree``."""
    frames, _ = clip
    res = tpipe.process(frames, path=str(tmp_path / "amf"), config=MF_CONFIG, device="cpu")
    counters = res.metrics["counters"]
    assert counters.get("markerless") is True
    assert "board_probe_exhausted" not in counters
    assert np.isfinite(res.reprojection_rmse) and res.reprojection_rmse < 2.0
    assert len(res.points) >= 30 and np.isfinite(res.volume)


def test_resume_from_marker_free_checkpoint(runs, clip):
    """The (n_kf, 0, 2) corners sentinel brings the run back marker-free."""
    frames, _ = clip
    with pytest.MonkeyPatch.context() as mp:
        _inject_bootstrap(mp)
        again = tpipe.process(frames, config=MF_CONFIG, device="cpu", checkpoint_dir=str(runs["out"] / "ckpt"))
    assert "pass1_keyframes" not in again.metrics["timings"]
    assert again.metrics["counters"]["markerless"] is True
    np.testing.assert_allclose(again.points, runs["torch"].points, atol=1e-4)


def test_automatic_fallback_on_the_device_pass1(clip):
    """No board: the device hunt gives up after ``board_probe_frames`` (the
    whole first chunk of 8 frames is probed), and a second, marker-free
    pass 1 selects the same keyframes as the JAX package's."""
    frames, _ = clip
    with pytest.MonkeyPatch.context() as mp:
        _inject_bootstrap(mp)
        res_j = jpipe.process(frames, config=FALLBACK_JAX_CONFIG)
        res_t = tpipe.process(frames, config=FALLBACK_CONFIG, device="cpu")
    cj, ct = res_j.metrics["counters"], res_t.metrics["counters"]
    assert ct["markerless"] is True and cj["markerless"] is True
    assert ct["board_probe_exhausted"] == cj["board_probe_exhausted"] == 8
    assert ct["keyframe_indices"] == cj["keyframe_indices"]
    assert np.isfinite(res_t.reprojection_rmse) and res_t.reprojection_rmse < 2.0


def test_structureless_video_raises():
    """Pure noise: the fallback engages and fails with a described error
    (``test_pipeline.py::TestFailurePaths``)."""
    frames = np.random.default_rng(0).integers(0, 255, size=(10, 120, 160, 3), dtype=np.uint8)
    config = dataclasses.replace(FALLBACK_CONFIG, board_probe_frames=45)
    with pytest.raises(ValueError):
        tpipe.process(frames, config=config, device="cpu")


# --------------------------------------------------------------------------
# Incremental BA
# --------------------------------------------------------------------------


def _ba_arrays(seed=3, n_f=6, n_p=120):
    rng = np.random.default_rng(seed)
    k = f32([[300.0, 0, 64], [0, 300.0, 48], [0, 0, 1]])
    pts = rng.normal(size=(n_p, 3)) * 2.0
    cams = np.hstack([rng.normal(size=(n_f, 3)) * 0.05, rng.normal(size=(n_f, 3))]) + [0, 0, 0, 0, 0, 12]
    seen = rng.random((n_p, n_f)) < 0.7
    seen[:, :2] = True
    pidx, fidx = np.nonzero(seen)
    obs = np.asarray(jproj.project_points(pts[pidx], cams[fidx], k)) + rng.normal(scale=0.5, size=(len(pidx), 2))
    ext0 = np.asarray(jproj.extrinsics_from_params(f32(cams + rng.normal(size=cams.shape) * 0.01)))
    return dict(
        ext=f32(ext0), k=k, points=f32(pts + rng.normal(size=pts.shape) * 0.05), obs=f32(obs),
        fidx=fidx.astype(np.int32), pidx=pidx.astype(np.int32), weight=f32(1.0 / 1.2 ** rng.integers(0, 3, len(pidx))),
        sigma=f32(np.ones(n_p)), parallax=f32(np.full(n_p, 10.0)),
    )


def test_incremental_ba_matches_jax():
    """``incremental_ba=True``: JAX's and the port's ``_solve_and_finish`` on
    one PreBA: per-prefix rmse within 5%, the same number of prefixes,
    final points within 1e-3."""
    a = _ba_arrays()
    n_f = a["ext"].shape[0]
    jcfg = dataclasses.replace(TEST_CONFIG, incremental_ba=True)
    pre_j = jpipe.PreBA(
        ext_refined=jnp.asarray(a["ext"]), intrinsics=jnp.asarray(a["k"]), dist=jnp.zeros(5, jnp.float32),
        points=a["points"], obs=a["obs"], fidx=a["fidx"], pidx=a["pidx"], obs_weight=a["weight"],
        point_sigma=a["sigma"], point_parallax=a["parallax"], n_kf=n_f, image_size=(128, 96),
        frames_total=n_f, markerless=True,
    )
    pre_t = tpipe.PreBA(
        ext_refined=tt(a["ext"]), intrinsics=tt(a["k"]), dist=torch.zeros(5), points=tt(a["points"]),
        obs=tt(a["obs"]), fidx=tt(a["fidx"]).long(), pidx=tt(a["pidx"]).long(), obs_weight=tt(a["weight"]),
        point_sigma=tt(a["sigma"]), point_parallax=tt(a["parallax"]), image_size=(128, 96), markerless=True,
    )
    res_j = jpipe._solve_and_finish(pre_j, jcfg, JMetrics(), JCheckpointer(None), None)
    res_t = tpipe._solve_and_finish(pre_t, from_fields(jcfg), TMetrics(), TCheckpointer(None), None)
    sj = res_j.metrics["counters"]["ba_rmse_px_steps"]
    st = res_t.metrics["counters"]["ba_rmse_px_steps"]
    assert len(st) == len(sj) == n_f - 2
    np.testing.assert_allclose(st, sj, rtol=0.05)
    assert res_t.metrics["counters"]["ba_iterations_total"] > 0
    np.testing.assert_allclose(res_t.points, res_j.points, atol=1e-3)
    np.testing.assert_allclose(res_t.reprojection_rmse, sj[-1], rtol=0.05)
