"""The board-finding default path: the port's ``process(device="cpu")``
against the JAX ``process`` on the test-suite scene (400x300, 40 frames,
seed 0) with NO known corners, under the small test config with the JAX
package's defaults ``pass1_backend="device"`` and ``pass2_enhance="bgr_lab"``
and ``chessboard.detector="device"``.

Bounds (those of ``test_torch_pipeline.py``): identical keyframe indices,
focal within 0.5%, rmse within 10%, point count within 5%, hull volume
within 5%, and both runs meet the ground-truth checks of
``test_pipeline.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from meatmodeler_tpu.io.synthetic import render_sequence
from meatmodeler_tpu.pipeline import process as jax_process
from meatmodeler_tpu_torch.pipeline import process as torch_process
from meatmodeler_tpu_torch.testing import from_fields
from test_pipeline import SCENE, TEST_CONFIG

torch.set_num_threads(2)

JAX_CONFIG = dataclasses.replace(
    TEST_CONFIG, chessboard=dataclasses.replace(TEST_CONFIG.chessboard, detector="device")
)
# The same config in the port's own classes.
CONFIG = from_fields(JAX_CONFIG)


@pytest.fixture(scope="module")
def clip():
    frames, _, corners = render_sequence(SCENE, 40, seed=0)
    return frames, corners


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    frames, _ = clip
    out = tmp_path_factory.mktemp("device_slice")
    res_j = jax_process(frames, config=JAX_CONFIG)
    res_t = torch_process(frames, config=CONFIG, device="cpu", checkpoint_dir=str(out / "ckpt"))
    return {"jax": res_j, "torch": res_t, "out": out}


def test_config_is_the_default_path():
    assert (CONFIG.pass1_backend, CONFIG.pass2_enhance, CONFIG.chessboard.detector) == ("device", "bgr_lab", "device")


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


def test_stages_recorded(runs):
    m = runs["torch"].metrics
    for stage in ("pass1_keyframes", "board_detect", "pass2_preprocess", "pass2_orb", "bundle_adjustment"):
        assert stage in m["timings"]
    assert m["counters"]["frames_total"] == 40
    assert m["counters"]["keyframes_selected"] >= m["counters"]["keyframes"]


def test_device_pass1_spans(runs):
    """The device pass 1's parts are children of ``pass1_keyframes``: the
    decimation, the upload and CLAHE, the hunt for the first board, the
    scan, its flags' read and the keyframes kept; the board detection
    stays a stage of its own."""
    timings = runs["torch"].metrics["timings"]
    parts = {k.split("/", 1)[1] for k in timings if k.startswith("pass1_keyframes/")}
    assert {"decim", "upload", "board_hunt", "scan", "flags_read", "retain"} <= parts
    assert sum(timings[f"pass1_keyframes/{p}"] for p in parts if "/" not in p) <= timings["pass1_keyframes"]
    assert "board_detect" in timings and "pass2_orb/describe" in timings


def test_resume_from_checkpoint(runs, clip):
    frames, _ = clip
    again = torch_process(frames, config=CONFIG, device="cpu", checkpoint_dir=str(runs["out"] / "ckpt"))
    assert "pass1_keyframes" not in again.metrics["timings"]
    assert again.metrics["counters"]["keyframe_indices"] == runs["torch"].metrics["counters"]["keyframe_indices"]
    np.testing.assert_allclose(again.points, runs["torch"].points, atol=1e-4)


def test_known_corners_on_the_device_pass1(runs, clip):
    """The device pass 1's known-corner bootstrap (frame 0, corners from the
    caller) selects the same keyframes as the detector run: the scan is the
    same and the detector finds the board in every keyframe here."""
    frames, corners = clip
    res = torch_process(frames[:24], config=CONFIG, known_corners=corners[:24], device="cpu")
    kt = runs["torch"].metrics["counters"]["keyframe_indices"]
    assert res.metrics["counters"]["keyframe_indices"] == [i for i in kt if i < 24]


def test_boardless_clip_raises():
    """No board anywhere: as in the reference, the marker-free fallback
    engages (a second, board-free pass 1) and fails on pure noise with the
    reference's ValueError; with the fallback off it is the reference's
    ValueError about the chessboard."""
    frames = np.random.default_rng(0).integers(0, 256, size=(6, 120, 160, 3)).astype(np.uint8)
    with pytest.raises(ValueError, match="marker-free pose bootstrap failed"):
        torch_process(frames, config=CONFIG, device="cpu")
    with pytest.raises(ValueError, match="visible chessboard"):
        torch_process(frames, config=dataclasses.replace(CONFIG, markerless_fallback=False), device="cpu")
