"""The multi-video entry points of the port against the JAX package:
``solvers.bundle_adjust.solve_ba_batch`` against ``jax.vmap(solve_ba)``,
``parallel.batch.process_batch`` against the JAX ``process_batch`` with
``mesh=None`` and with a two-device mesh. (``process_batch_pipelined``:
``test_torch_pipelined.py``.)

Tolerances: the batched solve takes the same number of LM iterations per
lane as the JAX one, with cameras and points within 1e-4 relative (of each
lane's largest value); against the port's single-problem solve a padded lane
takes the same iterations and reprojects every observation within 1e-3 px
(padding adds decoupled rows to the reduced system, which moves the result
along the solve's free gauge, not its fit). These solver problems are
float64: in float32 they reach the cost's rounding floor within three
iterations, and from there whether a step lowers the cost, and so when a
lane stops, is decided by rounding in either package. ``process_batch`` with known
corners: the same keyframes and point counts as JAX, rmse within 1e-3 px,
hull volume within 0.5%."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meatmodeler_tpu.config import DEFAULT_CONFIG, KeyframeConfig, MatcherConfig, OrbConfig, TrackConfig, VolumeConfig
from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu.parallel import sharded as jsharded
from meatmodeler_tpu.parallel.batch import process_batch as jax_process_batch
from meatmodeler_tpu.solvers import bundle_adjust as jba
from meatmodeler_tpu_torch.geometry import projection as tproj
from meatmodeler_tpu_torch.parallel import pipelined as tpipelined
from meatmodeler_tpu_torch.parallel import sharded as tsharded
from meatmodeler_tpu_torch.parallel.batch import process_batch
from meatmodeler_tpu_torch.pipeline import process
from meatmodeler_tpu_torch.solvers import bundle_adjust as tba
from meatmodeler_tpu_torch.testing import from_fields
from test_bundle_adjust import make_problem

torch.set_num_threads(2)

# The quick pipelined test config of test_pipelined.py, with the headline's
# host pass 1 and grey keyframes so the batch prepass engages; its scene.
JAX_CONFIG = dataclasses.replace(
    DEFAULT_CONFIG,
    keyframe=dataclasses.replace(KeyframeConfig(), max_corners=128, threshold=0.03),
    orb=OrbConfig(num_features=512, num_levels=2),
    matcher=MatcherConfig(max_matches=256),
    tracks=TrackConfig(max_tracks=1024, max_keyframes=32),
    volume=VolumeConfig(voxel_resolution=32),
    frame_chunk=8,
    pass1_backend="host",
    pass2_enhance="grey",
)
CONFIG = from_fields(JAX_CONFIG)
SCENE = TurntableScene(image_size=(320, 240), focal=340.0, noise_sigma=1.0)
# A smaller batch for the tests that hold the port to itself.
TINY = dataclasses.replace(
    CONFIG,
    keyframe=dataclasses.replace(CONFIG.keyframe, threshold=0.015),
    orb=dataclasses.replace(CONFIG.orb, num_features=256),
    matcher=dataclasses.replace(CONFIG.matcher, max_matches=128),
    tracks=dataclasses.replace(CONFIG.tracks, max_tracks=512, max_keyframes=16),
    volume=dataclasses.replace(CONFIG.volume, voxel_resolution=24),
    frame_chunk=4,
)
TINY_SCENE = TurntableScene(image_size=(160, 120), focal=170.0, noise_sigma=0.5)


def _padded_problems(sizes):
    """``make_problem`` problems of different sizes and starting errors,
    float64, padded to common (F, P, N) as the batch pads them."""
    probs = []
    for seed, (nf, npt, pose_noise) in enumerate(sizes):
        k, _, _, cams0, pts0, obs, fidx, pidx = make_problem(
            n_frames=nf, n_points=npt, pose_noise=pose_noise, seed=10 + seed
        )
        w = 1.0 / 1.2 ** (np.arange(len(obs)) % 3)
        probs.append([np.asarray(a, np.float64) for a in (cams0, pts0, k, obs)]
                     + [fidx.astype(np.int64), pidx.astype(np.int64), np.ones(len(obs), bool), w])
    caps = [max(p[i].shape[0] for p in probs) for i in (0, 1, 3)]

    def pad(a, n):
        return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])

    batched = [
        np.stack([pad(p[i], caps[0] if i == 0 else caps[1] if i == 1 else caps[2]) if i != 2 else p[i] for p in probs])
        for i in range(8)
    ]
    return probs, batched


@pytest.fixture(scope="module")
def batched_solves():
    probs, batched = _padded_problems([(5, 40, 0.05), (8, 70, 0.01), (4, 25, 0.2)])
    jres = jax.vmap(lambda pr: jba.solve_ba(pr))(jba.BAProblem(*(jnp.asarray(a) for a in batched)))
    tres = tba.solve_ba_batch(tba.BAProblem(*(torch.from_numpy(a) for a in batched)))
    return probs, jres, tres


def test_solve_ba_batch_matches_jax_vmap(batched_solves):
    _, jres, tres = batched_solves
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    assert len(set(tres.iterations.tolist())) > 1  # the lanes stop apart
    for name in ("cam_params", "points"):
        t, j = getattr(tres, name).numpy(), np.asarray(getattr(jres, name))
        for lane in range(len(t)):
            scale = np.abs(j[lane]).max()
            np.testing.assert_allclose(t[lane], j[lane], rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tres.rmse.numpy(), np.asarray(jres.rmse), rtol=1e-4)
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost), rtol=1e-4)


def test_solve_ba_batch_lanes_match_single_solves(batched_solves):
    probs, _, tres = batched_solves
    for lane, (cams0, pts0, k, obs, fidx, pidx, mask, w) in enumerate(probs):
        solo = tba.solve_ba(tba.BAProblem(*(torch.from_numpy(a) for a in (cams0, pts0, k, obs, fidx, pidx, mask, w))))
        assert int(tres.iterations[lane]) == solo.iterations
        np.testing.assert_allclose(float(tres.rmse[lane]), float(solo.rmse), rtol=1e-4)
        nf, npt = len(cams0), len(pts0)
        proj_lane = tproj.project_points(
            tres.points[lane, :npt][pidx], tres.cam_params[lane, :nf][fidx], torch.from_numpy(k)
        )
        proj_solo = tproj.project_points(solo.points[pidx], solo.cam_params[fidx], torch.from_numpy(k))
        np.testing.assert_allclose(proj_lane.numpy(), proj_solo.numpy(), atol=1e-3)
        # Padded cameras and points do not move.
        assert not tres.cam_params[lane, nf:].any() and not tres.points[lane, npt:].any()


def _clips(scene, n_frames):
    frames, corners = [], []
    for seed in (0, 1):
        f, _, c = render_sequence(scene, n_frames, seed=seed)
        frames.append(f)
        corners.append(c)
    return frames, corners


@pytest.fixture(scope="module")
def clips():
    return _clips(TINY_SCENE, 10)


# The config of the batches through both packages (one JAX compile).
BATCH_CONFIG = dataclasses.replace(JAX_CONFIG, chessboard=dataclasses.replace(JAX_CONFIG.chessboard, detector="device"))


@pytest.fixture(scope="module")
def clips16():
    return _clips(SCENE, 16)


@pytest.fixture(scope="module")
def batch_runs(tmp_path_factory, clips16):
    """One batch through both packages: the first clip with its known
    corners, the second alone, its boards found by the device detector."""
    frames, corners = clips16
    known = [corners[0], None]
    out = tmp_path_factory.mktemp("batch")
    cfg = BATCH_CONFIG
    jres = jax_process_batch(frames, config=cfg, mesh=None, known_corners=known)
    tres = process_batch(
        frames, config=from_fields(cfg), known_corners=known, device="cpu", paths=[str(out / "a"), str(out / "b")]
    )
    return jres, tres, out


def test_process_batch_known_corners_matches_jax(batch_runs):
    j, t = batch_runs[0][0], batch_runs[1][0]
    jc, tc = j.metrics["counters"], t.metrics["counters"]
    assert tc["batch_fast_prepass"] is True and jc["batch_fast_prepass"] is True
    assert tc["keyframe_indices"] == jc["keyframe_indices"]
    assert len(t.points) == len(j.points) > 100
    np.testing.assert_allclose(t.reprojection_rmse, j.reprojection_rmse, atol=1e-3)
    np.testing.assert_allclose(t.volume, j.volume, rtol=5e-3)
    assert t.volume_confidence["low_confidence"] == j.volume_confidence["low_confidence"]


def test_process_batch_prepass_with_device_detector(batch_runs):
    """Video alone, ``detector="device"`` on both sides: the prepass scans
    on the host and detects the boards on the device, keyframes equal."""
    j, t = batch_runs[0][1], batch_runs[1][1]
    jc, tc = j.metrics["counters"], t.metrics["counters"]
    assert tc["batch_fast_prepass"] is True and jc["batch_fast_prepass"] is True
    assert tc["keyframe_indices"] == jc["keyframe_indices"] and len(tc["keyframe_indices"]) >= 3
    assert abs(len(t.points) - len(j.points)) <= 0.05 * len(j.points)
    assert t.reprojection_rmse < 1.0


def test_process_batch_results_and_ply(batch_runs):
    _, tres, out = batch_runs
    for r, name in zip(tres, ("a", "b")):
        assert r.ply_path == str(out / name) + "Cloud.ply"
        assert np.isfinite(r.points).all() and r.extrinsics.shape == (r.metrics["counters"]["keyframes"], 4, 4)
        assert set(r.metrics["counters"]) >= {
            "ba_rmse_px", "ba_iterations", "points", "item_points", "volume_low_confidence", "keyframes",
            "kf_scale", "keyframe_indices",
        }
        assert set(r.volume_confidence) >= {"low_confidence", "view_arc_deg", "elongation", "reason", "n_item_points"}


def test_process_batch_with_mesh_matches_jax(batch_runs, clips16):
    """Three clips, known corners, over a two-device mesh (``sharded.
    make_mesh(data=2)``; the port's on virtual CPU shards): the batch pads
    to four lanes with a copy of the last problem in both packages, and per
    clip the keyframes and point counts are JAX's, rmse within 1e-3 px,
    hull volume within 0.5% (the bounds above)."""
    frames, corners = clips16
    frames, corners = frames + frames[:1], corners + corners[:1]
    jres = jax_process_batch(frames, config=BATCH_CONFIG, mesh=jsharded.make_mesh(data=2), known_corners=corners)
    tres = process_batch(
        frames, config=from_fields(BATCH_CONFIG), known_corners=corners, device="cpu",
        mesh=tsharded.make_mesh(data=2, devices=["cpu"] * 2),
    )
    assert len(tres) == 3
    for j, t in zip(jres, tres):
        assert t.metrics["counters"]["keyframe_indices"] == j.metrics["counters"]["keyframe_indices"]
        assert len(t.points) == len(j.points) > 100
        np.testing.assert_allclose(t.reprojection_rmse, j.reprojection_rmse, atol=1e-3)
        np.testing.assert_allclose(t.volume, j.volume, rtol=5e-3)


def test_nonuniform_batch_skips_the_prepass(clips):
    """Clips of different lengths take the per-video path; each result is
    the port's ``process`` of that video but for the batched solve (rmse
    within 1e-3 px: in float32 the two solves may stop an iteration apart
    at the cost's rounding floor)."""
    frames, corners = clips
    mixed, mixed_corners = [frames[0], frames[1][:8]], [corners[0], corners[1][:8]]
    tres = process_batch(mixed, config=TINY, known_corners=mixed_corners, device="cpu")
    for r, v, c in zip(tres, mixed, mixed_corners):
        assert r.metrics["counters"].get("batch_fast_prepass") is None
        single = process(v, config=TINY, known_corners=c, device="cpu")
        assert r.metrics["counters"]["keyframe_indices"] == single.metrics["counters"]["keyframe_indices"]
        assert len(r.points) == len(single.points)
        np.testing.assert_allclose(r.reprojection_rmse, single.reprojection_rmse, atol=1e-3)


def test_batch_needs_the_device_detector_without_corners(clips):
    """Without known corners the default detector ("auto") falls back to
    cv2 in the JAX package: the port refuses before any work."""
    frames, _ = clips
    with pytest.raises(NotImplementedError, match="cv2"):
        process_batch(frames, config=TINY, device="cpu")


@pytest.mark.parametrize("entry", ["batch", "pipelined"])
def test_cuda_default_raises_without_a_card(clips, entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames, corners = clips
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "batch":
            process_batch(frames, config=TINY, known_corners=corners)
        else:
            tpipelined.process_batch_pipelined(frames, config=TINY, known_corners=corners)


def test_process_batch_reports_its_spans_once(batch_runs):
    """The batch's own spans and counters: one dict, the same under
    ``metrics["batch"]`` of every result; the LM's spans time under
    ``batch_solve``, its iterations are the lanes' largest count and the
    lane-iterations their sum; no video's timings hold a batch span."""
    tres = batch_runs[1]
    batch = tres[0].metrics["batch"]
    assert all(r.metrics["batch"] is batch for r in tres)
    timings, counters = batch["timings"], batch["counters"]
    assert {"batch_prepass", "batch_pool", "batch_solve", "batch_solve/linearize", "batch_solve/solve",
            "batch_solve/decide"} <= set(timings)
    assert all(v > 0 for v in timings.values())
    iters = [r.metrics["counters"]["ba_iterations"] for r in tres]
    assert counters["lm_iterations:batch_solve"] == max(iters) > 0
    assert counters["lane_iterations:batch_solve"] == sum(iters)
    assert counters["lanes:batch_solve"] == len(tres)
    for r in tres:
        assert not any(k.startswith("batch_") for k in r.metrics["timings"])
        assert "pass1_keyframes" in r.metrics["timings"] and "pose_ba" in r.metrics["timings"]


@pytest.fixture(scope="module")
def traced_batch(clips16):
    """``batch_runs``' batch again, its stages synced and under a CPU
    profiler, with the stacked problem the batched LM was given and its
    result."""
    import os

    from meatmodeler_tpu_torch.parallel import batch as tbatch

    frames, corners = clips16
    seen = []
    real = tba.solve_ba_batch

    def solve_ba_batch(problem, *args, **kwargs):
        out = real(problem, *args, **kwargs)
        seen.append((problem, kwargs.get("config"), out))
        return out

    tbatch.bundle_adjust.solve_ba_batch = solve_ba_batch
    os.environ["MEATMODELER_SYNC_STAGES"] = "1"
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            tres = process_batch(frames, config=from_fields(BATCH_CONFIG), known_corners=[corners[0], None],
                                 device="cpu")
    finally:
        os.environ.pop("MEATMODELER_SYNC_STAGES")
        tbatch.bundle_adjust.solve_ba_batch = real
    ranges = {e.name for e in prof.events()}
    return tres, seen, ranges


def test_process_batch_is_unchanged_by_its_spans(batch_runs, traced_batch):
    """Synced and traced, each video's cameras, points, RMSE and iterations
    are bit for bit those of the untraced run, whose numbers the parity
    tests above hold to JAX's; the batch's spans are profiler ranges."""
    tres, _, ranges = traced_batch
    for a, b in zip(batch_runs[1], tres):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.extrinsics, b.extrinsics)
        assert a.reprojection_rmse == b.reprojection_rmse
        assert a.metrics["counters"]["ba_iterations"] == b.metrics["counters"]["ba_iterations"]
    assert {"batch_prepass", "batch_pool", "batch_solve", "batch_solve/decide"} <= ranges
    assert tres[0].metrics["batch"]["counters"]["lm_iterations:batch_solve"] == max(
        r.metrics["counters"]["ba_iterations"] for r in tres)


def test_the_batched_solve_is_the_one_outside_every_span(traced_batch):
    """The stacked problem solved again where no span or ``Metrics`` is open,
    as the batched solve ran before it had spans: every lane bit for bit."""
    _, seen, _ = traced_batch
    (problem, config, inside), = seen
    outside = tba.solve_ba_batch(problem, config=config)
    for name in ("cam_params", "points", "rmse", "iterations", "cost"):
        assert torch.equal(getattr(inside, name), getattr(outside, name)), name


def test_a_clip_the_prepass_leaves_hunts_its_board_on_the_device(clips16, monkeypatch):
    """A video alone for which the prepass finds fewer than 3 board
    keyframes takes the per-video path: with the headline's host pass 1,
    whose board hunt needs cv2, it scans and hunts on the device instead of
    raising; the other video keeps the prepass."""
    from meatmodeler_tpu_torch.parallel import batch as tbatch

    frames, corners = clips16
    real, calls = tbatch._resolve_board_corners, []

    def resolve(*args, **kwargs):
        calls.append(1)
        kf_frames, kf_corners, kf_indices = real(*args, **kwargs)
        return (kf_frames[:2], kf_corners[:2], kf_indices[:2]) if len(calls) == 1 else (kf_frames, kf_corners,
                                                                                          kf_indices)

    monkeypatch.setattr(tbatch, "_resolve_board_corners", resolve)
    config = from_fields(BATCH_CONFIG)
    assert config.pass1_backend == "host"
    tres = process_batch(frames, config=config, device="cpu")
    first, second = (r.metrics["counters"] for r in tres)
    assert first.get("batch_fast_prepass") is None and second["batch_fast_prepass"] is True
    assert first["keyframes"] >= 3 and np.isfinite(tres[0].points).all() and len(tres[0].points) > 0
