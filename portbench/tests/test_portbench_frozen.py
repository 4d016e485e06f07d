"""The frozen copies agree with the program code they were copied from, as
the program stands: the renderer (frames, poses, corners), the accuracy
arithmetic, the device-busy arithmetic and the kernels' work counts. A
later change to the program that breaks one of these leaves the benchmark
measuring as before; this test then says the copy has drifted."""

import json

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch.io import synthetic
from meatmodeler_tpu_torch.tools import clahe_bench, profile_headline, relpose_bench
from meatmodeler_tpu_torch.utils import alignment
from portbench.frozen import accuracy, busy, scene, work

TINY = dict(image_size=(64, 48), focal=60.0, noise_sigma=1.5)


@pytest.mark.parametrize("kwargs,color", [(TINY, True), (dict(TINY, show_board=False, ground_texture=12.0), False)])
def test_renderer_matches_the_programs(kwargs, color):
    ours = scene.render_sequence(scene.TurntableScene(**kwargs), 5, seed=2**33 + 7, color=color)
    theirs = synthetic.render_sequence(synthetic.TurntableScene(**kwargs), 5, seed=2**33 + 7, color=color,
                                       backend="torch")
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert scene.TurntableScene(**kwargs).volume == synthetic.TurntableScene(**kwargs).volume


def test_accuracy_matches_the_programs():
    rng = np.random.default_rng(0)
    src, dst = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    a, b = accuracy.umeyama(src, dst), alignment.umeyama(src, dst)
    assert a.scale == b.scale and np.array_equal(a.rotation, b.rotation)
    sc = scene.TurntableScene(**TINY)
    _, poses, _ = scene.render_sequence(sc, 6, seed=1)
    est = poses + rng.normal(scale=1e-2, size=poses.shape)
    ext = np.stack([np.vstack([np.hstack([profile_headline.so3.exp(torch.from_numpy(p[:3])).numpy(), p[3:, None]]),
                               [0, 0, 0, 1]]) for p in est])
    points = rng.normal(size=(30, 3)) + sc.ellipsoid_center

    class Res:
        extrinsics = ext
        metrics = {"counters": {"keyframe_indices": list(range(6))}}

    Res.points = points
    ours = accuracy.markerless_accuracy(range(6), ext, points, poses, sc)
    assert ours == profile_headline.markerless_accuracy(Res, poses, synthetic.TurntableScene(**TINY))

    class Odo:
        pass

    Odo.poses, Odo.num_tracked = est, np.arange(6) + 50
    theirs = profile_headline.odometry_accuracy(Odo, poses, first_steps=3)
    ours = accuracy.odometry_accuracy(est, Odo.num_tracked, poses, first_steps=3)
    assert ours == {k: theirs[k] for k in ours}


def test_device_busy_matches_the_programs(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 5}, {"ph": "X", "cat": "gpu_memcpy", "ts": 3, "dur": 4},
              {"ph": "X", "cat": "kernel", "ts": 20, "dur": 1}, {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 99}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert busy.device_busy(events) == profile_headline._device_busy(path) == (0.008, 2)


def test_work_counts_match_the_programs():
    assert work.HBM_BYTES_PER_S == clahe_bench.HBM_BYTES_PER_S
    assert work.FP32_FLOPS_PER_S == relpose_bench.FP32_FLOPS_PER_S
    for shape in [(22, 540, 960), (1, 720, 1280)]:
        assert work.clahe_lut_bytes(shape) == clahe_bench.lut_bytes(shape)
        assert work.clahe_apply_bytes(shape) == clahe_bench.apply_bytes(shape)
    n, h = 300, 64
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(n, 2, generator=g)
    mask = torch.rand(n, generator=g) > 0.3
    k = torch.eye(3)
    thr = torch.tensor(1e-4)
    cases = {
        "essential_hypotheses": (pts, pts, mask, k, torch.zeros(h, 8, dtype=torch.long), thr),
        "homography_hypotheses": (pts, pts, mask, torch.zeros(h, 4, dtype=torch.long), 3.0),
        "homography_polish": (pts, pts, mask, torch.zeros(h, 3, 3), torch.zeros(h), 3.0, k),
        "recover_pose": (torch.zeros(16, 3, 3), pts, pts, mask, k, thr),
        "score_candidates": (torch.zeros(24, 3), torch.zeros(24, 3), pts, pts, mask, k, thr),
    }
    for name, args in cases.items():
        assert work.hyp_work(name, args) == relpose_bench.hyp_work(name, args), name
