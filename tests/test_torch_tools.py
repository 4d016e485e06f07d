"""The headline profiling tool's host-side parts: the device-busy sum over a
chrome trace, and its refusal to run without CUDA."""

import dataclasses
import json

import pytest
import torch

from meatmodeler_tpu_torch.tools import profile_headline

torch.set_num_threads(2)


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_device_busy_is_the_union_of_device_spans(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "ts": 5, "dur": 10},  # overlaps the first
        {"ph": "X", "cat": "gpu_memcpy", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "gpu_memset", "ts": 32, "dur": 1},  # inside the copy
        {"ph": "X", "cat": "cuda_runtime", "ts": 0, "dur": 100},  # host side
        {"ph": "i", "cat": "kernel", "ts": 50},  # not a span
    ]
    busy_ms, kernels = profile_headline._device_busy(_trace(tmp_path, events))
    assert busy_ms == pytest.approx(20e-3)
    assert kernels == 2


def test_device_busy_empty_trace(tmp_path):
    assert profile_headline._device_busy(_trace(tmp_path, [])) == (0.0, 0)


def test_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")
    out = tmp_path / "report.json"
    assert profile_headline.main(["--warm-runs", "1", "--out", str(out)]) == 2
    assert not out.exists()


def test_detector_config_is_the_default_path():
    from meatmodeler_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT

    from meatmodeler_tpu_torch.testing import from_fields

    DEFAULT_CONFIG = from_fields(JAX_DEFAULT)
    base = dataclasses.replace(DEFAULT_CONFIG, pass1_backend="host", pass2_enhance="grey")
    cfg = profile_headline.detector_config(base)
    assert (cfg.pass1_backend, cfg.pass2_enhance, cfg.chessboard.detector) == ("device", "bgr_lab", "device")
    assert (DEFAULT_CONFIG.pass1_backend, DEFAULT_CONFIG.pass2_enhance) == (cfg.pass1_backend, cfg.pass2_enhance)
    assert cfg.keyframe == base.keyframe and cfg.chessboard.pattern == base.chessboard.pattern



def test_markerless_clip_and_config_are_the_jax_bench_variant():
    """``markerless_clip`` renders ``bench.markerless_scene()``; the config
    is ``headline_config()`` with the four changes of ``bench.run_markerless``."""
    import bench

    from meatmodeler_tpu_torch.io.synthetic import TurntableScene
    from meatmodeler_tpu_torch.testing import from_fields

    scene = from_fields(bench.markerless_scene(), TurntableScene)
    assert scene == TurntableScene(
        image_size=(1280, 720), focal=1000.0, noise_sigma=1.0, show_board=False, ground_texture=12.0
    )
    assert profile_headline.MARKERLESS_FRAMES == bench.MF_FRAMES
    head, cfg = profile_headline.headline_config(), profile_headline.markerless_config()
    assert (cfg.pass1_downscale, cfg.keyframe.flow_threshold, cfg.assume_markerless, cfg.markerless_focal) == (4, 0.0, True, 0.0)
    assert dataclasses.replace(
        cfg, pass1_downscale=head.pass1_downscale, keyframe=head.keyframe, assume_markerless=False
    ) == head
    assert (cfg.orb.num_features, cfg.orb.num_levels, cfg.tracks.max_tracks, cfg.volume.voxel_resolution) == (4096, 4, 8192, 64)


def test_markerless_accuracy_of_an_exact_reconstruction():
    """Keyframe poses that are the truth moved rigidly (a rotation, a shift)
    and points on the true surfaces score zero pose RMSE and zero surface
    residual at scale 1. (The anchors sit a fixed distance from each
    camera, as in the JAX package's bench, so only a rigid move is exact.)"""
    import types

    import numpy as np

    from meatmodeler_tpu_torch.geometry import projection
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence

    scene = TurntableScene(image_size=(160, 120), show_board=False)
    _, poses, _ = render_sequence(scene, 9, seed=1)
    kf = [0, 4, 8]
    ext = projection.extrinsics_from_params(torch.from_numpy(poses[kf]).double(), homogeneous=True).numpy()
    # World' = s R0 World + t0 changes each camera to [R R0^T | s t - R R0^T t0].
    s, r0 = 1.0, projection.extrinsics_from_params(torch.tensor([[0.1, -0.2, 0.3, 0, 0, 0]]).double())[0, :, :3].numpy()
    t0 = np.array([1.0, 2.0, -0.5])
    ext2 = ext.copy()
    ext2[:, :3, :3] = ext[:, :3, :3] @ r0.T
    ext2[:, :3, 3] = s * ext[:, :3, 3] - np.einsum("fij,j->fi", ext2[:, :3, :3], t0)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(50, 3))
    pts = np.array(scene.ellipsoid_center) + np.array(scene.ellipsoid_axes) * d / np.linalg.norm(d, axis=1, keepdims=True)
    res = types.SimpleNamespace(
        extrinsics=ext2, points=s * pts @ r0.T + t0, metrics={"counters": {"keyframe_indices": kf}}
    )
    acc = profile_headline.markerless_accuracy(res, poses, scene)
    assert acc["aligned_pose_rmse"] < 1e-6 and acc["point_surface_residual_median"] < 1e-6
    assert abs(acc["gauge_scale"] - 1.0) < 1e-6


def test_synced_calls_time_each_odometry_call_and_restore_them():
    """The odometry's synced run: every call of ``ODOMETRY_STAGES`` is timed
    (the run's result unchanged), and the modules get their functions back."""
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.odometry import chain_poses

    scene = TurntableScene(image_size=(200, 150), focal=210.0, noise_sigma=0.5)
    frames, _, _ = render_sequence(scene, 3, seed=3)
    before = [getattr(m, n) for m, n in profile_headline.ODOMETRY_STAGES]

    def run():
        return chain_poses(frames, scene.intrinsics, generator=torch.Generator().manual_seed(0), device="cpu")

    res, sums = profile_headline.synced_calls(run, profile_headline.ODOMETRY_STAGES)
    assert [getattr(m, n) for m, n in profile_headline.ODOMETRY_STAGES] == before
    assert set(sums) == {n for _, n in profile_headline.ODOMETRY_STAGES}
    for name in ("clahe", "build_pyramid", "lucas_kanade", "estimate_relative_pose", "triangulate_pairs"):
        assert sums[name] > 0, name
    again = run()
    assert (res.poses == again.poses).all()
