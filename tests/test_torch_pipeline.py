"""The headline slice: the port's ``process(device="cpu")`` against the JAX
``process`` on the test-suite scene (400x300, 40 frames, seed 0) with its
ground-truth corners, under the small test config plus the headline's
``pass1_backend="host"`` and ``pass2_enhance="grey"``. The board-finding
default path is ``test_torch_pipeline_device.py``.

Bounds: identical keyframes (the host scan is shared), focal within 0.5%,
rmse within 10%, point count within 5%, hull volume within 5%, and both
runs meet the ground-truth checks of ``test_pipeline.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from meatmodeler_tpu.io import ply
from meatmodeler_tpu.io.synthetic import render_sequence
from meatmodeler_tpu.pipeline import process as jax_process
from meatmodeler_tpu_torch.pipeline import process as torch_process
from meatmodeler_tpu_torch.testing import from_fields
from test_pipeline import SCENE, TEST_CONFIG

torch.set_num_threads(2)

JAX_CONFIG = dataclasses.replace(TEST_CONFIG, pass1_backend="host", pass2_enhance="grey")
# The same config in the port's own classes.
CONFIG = from_fields(JAX_CONFIG)


@pytest.fixture(scope="module")
def clip():
    frames, _, corners = render_sequence(SCENE, 40, seed=0)
    return frames, corners


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    frames, corners = clip
    out = tmp_path_factory.mktemp("slice")
    res_j = jax_process(frames, path=str(out / "jax"), config=JAX_CONFIG, known_corners=corners)
    res_t = torch_process(
        frames, path=str(out / "torch"), config=CONFIG, known_corners=corners,
        device="cpu", checkpoint_dir=str(out / "ckpt"),
    )
    return {"jax": res_j, "torch": res_t, "out": out}


def test_same_keyframes(runs):
    kj = runs["jax"].metrics["counters"]["keyframe_indices"]
    kt = runs["torch"].metrics["counters"]["keyframe_indices"]
    assert len(kj) >= 3
    assert kt == kj


def test_focal_rmse_points_volume_agree(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t.intrinsics[0, 0], j.intrinsics[0, 0], rtol=0.005)
    np.testing.assert_allclose(t.reprojection_rmse, j.reprojection_rmse, rtol=0.10)
    assert abs(len(t.points) - len(j.points)) <= 0.05 * len(j.points)
    np.testing.assert_allclose(t.volume, j.volume, rtol=0.05)


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_ground_truth(runs, which):
    """The checks of test_pipeline.py::TestEndToEnd on each run."""
    res = runs[which]
    assert res.points.shape[1] == 3 and len(res.points) > 50
    assert np.isfinite(res.points).all()
    k = res.intrinsics
    assert abs(k[0, 0] - SCENE.focal) / SCENE.focal < 0.05, k
    assert abs(k[1, 1] - SCENE.focal) / SCENE.focal < 0.05, k
    assert abs(k[0, 2] - 200) < 20 and abs(k[1, 2] - 150) < 20, k
    assert res.reprojection_rmse < 2.0
    assert 0.80 * SCENE.volume < res.volume < 1.20 * SCENE.volume


def test_ply_written(runs):
    res = runs["torch"]
    assert res.ply_path == str(runs["out"] / "torch") + "Cloud.ply"
    np.testing.assert_allclose(ply.read_ply(res.ply_path), res.points.astype(np.float32), rtol=1e-5)


def test_metrics_populated(runs):
    m = runs["torch"].metrics
    assert m["counters"]["keyframes"] >= 3
    for stage in ("pass1_keyframes", "pass2_orb", "calibration", "bundle_adjustment", "volume"):
        assert stage in m["timings"]
    assert m["counters"]["matches_per_pair"] == runs["jax"].metrics["counters"]["matches_per_pair"]


def test_resume_from_checkpoint(runs, clip):
    frames, corners = clip
    again = torch_process(
        frames, config=CONFIG, known_corners=corners, device="cpu",
        checkpoint_dir=str(runs["out"] / "ckpt"),
    )
    assert "pass1_keyframes" not in again.metrics["timings"]
    np.testing.assert_allclose(again.points, runs["torch"].points, atol=1e-4)


@pytest.mark.parametrize(
    "change",
    [dict(incremental_ba=True, pass1_backend="device"), dict(assume_markerless=True), dict(pass1_backend="host")],
)
def test_unported_options_raise(clip, change):
    """Without known corners, on the device detector, the first 16 frames:
    incremental BA (on the device pass 1) and the marker-free path (on the
    host pass 1) run (the latter up to scale,
    flagged ``markerless``); the host pass 1's board hunt needs cv2, which
    the port does not use, and still raises."""
    frames, corners = clip
    config = dataclasses.replace(
        CONFIG, chessboard=dataclasses.replace(CONFIG.chessboard, detector="device"), **change
    )
    if change == dict(pass1_backend="host"):
        with pytest.raises(NotImplementedError, match="cv2"):
            torch_process(frames[:16], config=config, device="cpu")
        return
    res = torch_process(frames[:16], config=config, device="cpu")
    counters = res.metrics["counters"]
    assert counters["keyframes"] >= 3 and np.isfinite(res.points).all() and len(res.points) > 0
    assert np.isfinite(res.reprojection_rmse) and res.reprojection_rmse < 2.0
    if change.get("incremental_ba"):
        steps = counters["ba_rmse_px_steps"]
        assert len(steps) == counters["keyframes"] - 2 and np.isfinite(steps).all()
        assert counters["ba_iterations_total"] >= counters["ba_iterations"]
        assert "markerless" not in counters
    else:
        assert counters["markerless"] is True
        assert "board_probe_exhausted" not in counters


def test_tf32_settings_restored(clip):
    """``process`` runs in full fp32 and gives the caller's TF32 settings
    back, also when it raises (four frames hold too few keyframes)."""
    frames, corners = clip
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="keyframes"):
            torch_process(frames[:4], config=CONFIG, known_corners=corners[:4], device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_known_corners_required(clip):
    """The default detector ("auto") detects boards with cv2, which the port
    does not use: without known corners it raises and says so."""
    config = dataclasses.replace(CONFIG, pass1_backend="device")
    with pytest.raises(NotImplementedError, match="cv2"):
        torch_process(clip[0][:4], config=config, device="cpu")


def test_host_detector_needs_cv2(clip):
    config = dataclasses.replace(
        CONFIG, pass1_backend="device", chessboard=dataclasses.replace(CONFIG.chessboard, detector="host")
    )
    with pytest.raises(NotImplementedError, match="cv2"):
        torch_process(clip[0][:4], config=config, device="cpu")
