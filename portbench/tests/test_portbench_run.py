"""Whole runs of the harness: without a card a measurement fails and prints
no result; on the CPU, at a tiny size and past the look for a card, a run
prints the contract's keys and is correct, the control's readings lie above
the limits and the program's below, and each fault planted under the timed
path makes ``correct`` false. On the card (``-m gpu``) one short run of a
real cell."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from portbench import control, run, spec
from portbench.tests.tiny import tiny_root

LAST_LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "board_known_1080p", "--seed", "3", "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


@pytest.fixture(scope="module")
def tiny_root_1(tmp_path_factory):
    """The tiny cells with one clip a run and one answer checked."""
    root = tiny_root(tmp_path_factory.mktemp("tiny"), checks=1)
    for name in ("tiny_known", "tiny_odometry"):
        traffic = root / "portbench" / "traffic" / f"{name}.json"
        traffic.write_text(json.dumps(dict(json.loads(traffic.read_text()), clips=1)))
    return root


@pytest.fixture(scope="module")
def tiny(tiny_root_1):
    return spec.resolve("tiny_known", tiny_root_1)


@pytest.fixture(scope="module")
def tiny_odometry(tiny_root_1):
    return spec.resolve("tiny_odometry", tiny_root_1)


def test_a_run_prints_the_contracts_keys(tiny):
    torch.set_num_threads(4)
    res = run.measure(tiny, 2**31 + 11, 0.0, False, "cpu")
    assert list(res) == LAST_LINE_KEYS
    assert res["correct"] and res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"fps", "rmse_px", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def _unchanged_ba(monkeypatch):
    """The global bundle adjustment returns its starting state."""
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    real = bundle_adjust.adjust_points

    def adjust_points(*args, config=None, **kwargs):
        return real(*args, config=dataclasses.replace(config, max_iters=0), **kwargs)

    monkeypatch.setattr(bundle_adjust, "adjust_points", adjust_points)


def _half_the_observations(monkeypatch):
    """The global bundle adjustment solves on every other observation."""
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    real = bundle_adjust.adjust_points

    def adjust_points(extrinsics, intrinsics, points_3d, points_2d, *args, **kwargs):
        mask = torch.zeros(points_2d.shape[0], dtype=torch.bool)
        mask[::2] = True
        return real(extrinsics, intrinsics, points_3d, points_2d, *args, mask=mask, **kwargs)

    monkeypatch.setattr(bundle_adjust, "adjust_points", adjust_points)


def _altered_keyframe(monkeypatch):
    """Pass 2 enhances its first keyframe two grey levels too bright."""
    from meatmodeler_tpu_torch.ops import clahe

    real = clahe.clahe

    def altered(img, *args, **kwargs):
        out = real(img, *args, **kwargs)
        if out.ndim == 3:
            out[0] += 2.0
        return out

    monkeypatch.setattr(clahe, "clahe", altered)


def _altered_rmse(monkeypatch):
    """The reported reprojection RMSE is 1% low."""
    from meatmodeler_tpu_torch import pipeline

    real = pipeline._solve_and_finish

    def solve_and_finish(*args, **kwargs):
        res = real(*args, **kwargs)
        return res._replace(reprojection_rmse=0.99 * res.reprojection_rmse)

    monkeypatch.setattr(pipeline, "_solve_and_finish", solve_and_finish)


def _unrefined_corners(monkeypatch):
    """Sub-pixel refinement returns the corners it was given."""
    from meatmodeler_tpu_torch.ops import chessboard

    monkeypatch.setattr(chessboard, "refine_corners_subpix", lambda img, corners, *args, **kwargs: corners.clone())


def _focal_off(monkeypatch):
    """Calibration returns a focal length 1% long."""
    from meatmodeler_tpu_torch.geometry import calibration

    real = calibration.calibrate

    def calibrate(*args, **kwargs):
        res = real(*args, **kwargs)
        k = res.intrinsics.clone()
        k[0, 0] *= 1.01
        k[1, 1] *= 1.01
        return res._replace(intrinsics=k)

    monkeypatch.setattr(calibration, "calibrate", calibrate)


@pytest.mark.parametrize("fault,caught_by", [
    (_unchanged_ba, "ba_gain"), (_half_the_observations, "ba_gain"),
    (_altered_keyframe, "keyframes_gap"), (_altered_rmse, "rmse_gap"),
    (_unrefined_corners, "corner_step_px"), (_focal_off, "board_gain"),
])
def test_a_fault_under_the_timed_path_is_not_correct(tiny, monkeypatch, fault, caught_by):
    torch.set_num_threads(4)
    fault(monkeypatch)
    res = run.measure(tiny, 5, 0.0, False, "cpu")
    assert not res["correct"] and res["failed"] == 1
    assert res["checks"][caught_by]["value"] > res["checks"][caught_by]["limit"]


def _unrefined_pose(monkeypatch):
    """The relative pose's refinement returns its starting candidates."""
    from meatmodeler_tpu_torch.geometry import ransac

    monkeypatch.setattr(ransac, "refine_relative_pose", lambda rvec, tvec, *args, **kwargs: (rvec, tvec))


def _untracked(monkeypatch):
    """Lucas-Kanade returns its start points as the tracked ones."""
    from meatmodeler_tpu_torch.ops import klt

    real = klt.lucas_kanade

    def lucas_kanade(prev_pyr, curr_pyr, points, *args, **kwargs):
        return real(prev_pyr, curr_pyr, points, *args, **kwargs)._replace(points=points.clone())

    monkeypatch.setattr(klt, "lucas_kanade", lucas_kanade)


def _half_the_pairs(monkeypatch):
    """The relative pose is estimated from every other tracked pair."""
    from meatmodeler_tpu_torch.geometry import ransac

    real = ransac.estimate_relative_pose

    def estimate(pts1, pts2, mask, *args, **kwargs):
        half = mask.clone()
        half[1::2] = False
        return real(pts1, pts2, half, *args, **kwargs)

    monkeypatch.setattr(ransac, "estimate_relative_pose", estimate)


def _altered_chain(monkeypatch):
    """A chained pose is altered where it is produced."""
    from meatmodeler_tpu_torch import odometry

    real = odometry._compose
    monkeypatch.setattr(odometry, "_compose", lambda *args: real(*args) * 1.001)


def _half_left_at_start(monkeypatch):
    """Lucas-Kanade leaves every other point at its start and reports it
    tracked."""
    from meatmodeler_tpu_torch.ops import klt

    real = klt.lucas_kanade

    def lucas_kanade(prev_pyr, curr_pyr, points, *args, **kwargs):
        flow = real(prev_pyr, curr_pyr, points, *args, **kwargs)
        moved = flow.points.clone()
        moved[::2] = points[::2]
        return flow._replace(points=moved)

    monkeypatch.setattr(klt, "lucas_kanade", lucas_kanade)


def _half_lost(monkeypatch):
    """Lucas-Kanade reports every other point lost."""
    from meatmodeler_tpu_torch.ops import klt

    real = klt.lucas_kanade

    def lucas_kanade(*args, **kwargs):
        flow = real(*args, **kwargs)
        status = flow.status.clone()
        status[::2] = False
        return flow._replace(status=status)

    monkeypatch.setattr(klt, "lucas_kanade", lucas_kanade)


def _some_steps_unrefined(monkeypatch):
    """The relative pose's refinement returns its starting candidates on
    one call in four."""
    from meatmodeler_tpu_torch.geometry import ransac

    real, calls = ransac.refine_relative_pose, []

    def refine(rvec, tvec, *args, **kwargs):
        calls.append(1)
        return (rvec, tvec) if len(calls) % 4 == 0 else real(rvec, tvec, *args, **kwargs)

    monkeypatch.setattr(ransac, "refine_relative_pose", refine)


def _depths_off(monkeypatch):
    """Every other step's triangulated depths come out 10% long, so its
    depth ratio, and the scale chained from it, is off."""
    from meatmodeler_tpu_torch.geometry import triangulation

    real, calls = triangulation.triangulate_pairs, []

    def triangulate(*args, **kwargs):
        calls.append(1)
        out = real(*args, **kwargs)
        return out * 1.1 if len(calls) % 2 == 0 else out

    monkeypatch.setattr(triangulation, "triangulate_pairs", triangulate)


@pytest.mark.parametrize("fault,caught_by", [
    (_unrefined_pose, "pose_gain"), (_untracked, "track_step_px"), (_half_the_pairs, "pose_gain"),
    (_altered_chain, "chain_gap"), (_half_left_at_start, "track_step_px"), (_half_lost, "track_step_px"),
    (_some_steps_unrefined, "pose_gain_p90"), (_depths_off, "scale_gap"),
])
def test_a_fault_under_the_odometry_is_not_correct(tiny_odometry, monkeypatch, fault, caught_by):
    torch.set_num_threads(4)
    fault(monkeypatch)
    res = run.measure(tiny_odometry, 5, 0.0, False, "cpu")
    assert not res["correct"] and res["failed"] == 1
    assert res["checks"][caught_by]["value"] > res["checks"][caught_by]["limit"]


@pytest.mark.parametrize("cell", ["tiny", "tiny_odometry"])
def test_the_control_reads_above_the_limits(cell, request):
    """The readings the limits are set from, at a tiny size: the program's
    numbers under the limits, the control's (the reference in bfloat16 in
    the program's place) above them."""
    cell = request.getfixturevalue(cell)
    torch.set_num_threads(4)
    out = control.readings(cell, [7], {7}, 1, "cpu")
    for name, limit in cell.limits.items():
        assert out["lower"][name] <= limit < out["upper"][name], name


@pytest.mark.gpu
def test_a_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card only")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "board_known_1080p", "--seed",
                           "2147483659", "--seconds", "1", "--trace", "0"], cwd=spec.REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res) == LAST_LINE_KEYS and res["correct"] and res["device"]["platform"] == "gpu"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
