"""The odometry's scale step on the CPU: ``odometry.scale_step_reference``
(the plain version that CPU tensors run and that the CUDA kernel
``csrc/scale_step.cu`` is held to on the card) against the step body
``chain_poses`` ran before the kernel, bit for bit at recorded steps; the
median rule at odd and even counts and at 8 and 7 qualifying slots; the
edge cases of ``tools/scale_step_bench.step_case``; the chain's record;
that CPU tensors never build, load or count the kernel; and that the kernel
is built into the relative pose's library."""

import os

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch import odometry
from meatmodeler_tpu_torch.geometry import projection, ransac_hyp_cuda, so3, triangulation
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.tools import scale_step_bench as sb

torch.set_num_threads(2)

SCENE = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=0.5)


def _compose(pose_a, rvec_rel, tvec_rel):
    r_a = so3.exp(torch.from_numpy(pose_a[:3])).numpy()
    r_rel = so3.exp(torch.from_numpy(rvec_rel)).numpy()
    r_b = r_rel @ r_a
    t_b = r_rel @ pose_a[3:] + tvec_rel
    return np.concatenate([so3.log(torch.from_numpy(r_b)).numpy(), t_b])


def _step_before(pts, flow_points, inliers, rvec, tvec, k, prev_depth, prev_scale, prev_pose):
    """The scale step as ``chain_poses`` ran it before the kernel, line for
    line: (pose, scale, new depths)."""
    eye = torch.eye(3, 4)
    inl = inliers.cpu().numpy()
    ext2 = projection.extrinsics_from_params(torch.cat([rvec, tvec])[None])[0]
    n = pts.shape[0]
    pts3d = triangulation.triangulate_pairs(
        (k @ eye).expand(n, 3, 4), (k @ ext2).expand(n, 3, 4), pts, flow_points
    ).cpu().numpy()
    ext2 = ext2.cpu().numpy()
    depth_cur = pts3d[:, 2]
    ok_depth = inl & np.isfinite(depth_cur) & (depth_cur > 1e-3)
    both = ok_depth & np.isfinite(prev_depth)
    if both.sum() >= 8:
        scale = float(np.median(prev_depth[both] / depth_cur[both]))
    else:
        scale = prev_scale
    pose = _compose(prev_pose, rvec.cpu().numpy(), tvec.cpu().numpy() * scale)
    cam_t = (ext2[:3, :3] @ pts3d.T).T + ext2[:3, 3]
    new_depth = np.where(ok_depth, cam_t[:, 2] * scale, np.nan).astype(np.float32)
    return pose, scale, new_depth


@pytest.fixture(scope="module")
def frames():
    f, _, _ = render_sequence(SCENE, 8, seed=3)
    return f


@pytest.mark.parametrize("min_tracks", [40, 10_000])
def test_reference_is_the_step_before_bit_for_bit(frames, min_tracks):
    """At every recorded step (``min_tracks=10_000``: a reseed after every
    step, so no depth carries over), the plain version gives the former
    step's pose, scale and depths bit for bit, and the chain carries them:
    the next step starts from this one's pose, scale and depths (NaN after a
    reseed), and the result holds them."""
    res, steps = sb.record_steps(frames[:5] if min_tracks > 40 else frames, SCENE.intrinsics, device="cpu",
                                 generator=torch.Generator().manual_seed(0), min_tracks=min_tracks)
    assert len(steps) == len(res.poses) - 1
    held = 0
    for t, s in enumerate(steps, start=1):
        args = [s[n] for n in sb.ARG_NAMES[:6]]
        prev = (s["depth"].numpy(), float(s["prev_scale"]), s["prev_pose"].numpy())
        pose, scale, depth, was_held = odometry.scale_step_reference(*args, *prev)
        pose0, scale0, depth0 = _step_before(*args, *prev)
        np.testing.assert_array_equal(pose, pose0)
        assert scale == scale0 and depth.dtype == depth0.dtype == np.float32
        np.testing.assert_array_equal(depth, depth0)
        held += was_held
        np.testing.assert_array_equal(res.poses[t], pose0)
        assert res.scales[t] == np.float32(scale0)
        assert res.num_inliers[t] == int(s["inliers"].sum())
        if t < len(steps):
            nxt = steps[t]
            np.testing.assert_array_equal(nxt["prev_pose"].numpy(), pose0)
            assert float(nxt["prev_scale"]) == scale0
            carried = np.full_like(depth0, np.nan) if min_tracks > 40 else depth0
            np.testing.assert_array_equal(nxt["depth"].numpy(), carried)
    assert res.scales[0] == 0.0 and float(steps[0]["prev_scale"]) == 1.0
    assert res.metrics["counters"]["scale_held:odometry_scale"] == held
    assert held == (len(steps) if min_tracks > 40 else 1)  # the first step has no depths yet
    assert res.poses.dtype == np.float32 and res.poses.flags.c_contiguous and res.num_inliers.dtype == np.int64
    assert "odometry_scale/result" in res.metrics["timings"]


def _median_by_rule(case):
    """The median of the qualifying ratios by np.median's rule, computed
    here from the plain triangulation: the middle value, or the mean of the
    two middle ones; (value, count)."""
    k, rvec, tvec = case["intrinsics"], case["rvec"], case["tvec"]
    n = case["pts1"].shape[0]
    ext2 = projection.extrinsics_from_params(torch.cat([rvec, tvec])[None])[0]
    eye = torch.eye(3, 4, dtype=k.dtype)
    z = triangulation.triangulate_pairs((k @ eye).expand(n, 3, 4), (k @ ext2).expand(n, 3, 4), case["pts1"],
                                        case["pts2"])[:, 2].numpy()
    prev = case["depth"].numpy()
    both = case["inliers"].numpy() & np.isfinite(z) & (z > 1e-3) & np.isfinite(prev)
    ratios = np.sort(prev[both] / z[both])
    m = ratios.size
    if m == 0:
        return None, 0
    return (ratios[m // 2] if m % 2 else (ratios[m // 2 - 1] + ratios[m // 2]) / 2), m


@pytest.mark.parametrize("label", ["base", "slots_129", "ratios_9", "ratios_8", "ratios_7", "reseeded", "no_inliers",
                                   "bad_depths"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reference_median_rule_and_edges(label, dtype):
    """np.median's rule at odd and even counts; 8 qualifying slots give a
    median, 7 or none keep the previous scale; a slot behind the camera or
    below 1e-3 gets no depth, previous depths that are not finite give no
    ratio, no inliers give no depth at all."""
    case = sb.step_case(label, dtype=dtype)
    prev_scale = float(case["prev_scale"])
    pose, scale, depth, held = odometry.scale_step_reference(
        *(case[n] for n in sb.ARG_NAMES[:6]), case["depth"].numpy(), prev_scale, case["prev_pose"].numpy()
    )
    want, m = _median_by_rule(case)
    expected_m = {"ratios_9": 9, "ratios_8": 8, "ratios_7": 7, "reseeded": 0, "no_inliers": 0}
    if label in expected_m:
        assert m == expected_m[label]
    assert held == (m < 8)
    assert scale == (prev_scale if m < 8 else float(want))
    assert depth.dtype == case["depth"].numpy().dtype and pose.shape == (6,)
    if label == "no_inliers":
        assert np.isnan(depth).all()
    if label == "bad_depths":
        assert np.isnan(depth[:2]).all() and np.isfinite(depth[2:7]).all()
    # The chain's pose: the previous one composed with the scaled step.
    np.testing.assert_array_equal(pose, _compose(case["prev_pose"].numpy(), case["rvec"].numpy(),
                                                 case["tvec"].numpy() * scale))


def test_cpu_tensors_never_touch_the_kernel(frames, monkeypatch):
    """On the CPU the dispatch runs the plain version: the kernel's wrapper
    is never called, nothing is built or loaded, nothing is counted."""
    before = dict(ransac_hyp_cuda.LAUNCHES)

    def refuse(*_):
        raise AssertionError("the CPU path called the kernel")

    monkeypatch.setattr(ransac_hyp_cuda, "scale_step", refuse)
    res = odometry.chain_poses(frames[:3], SCENE.intrinsics, device="cpu")
    assert res.poses.shape == (3, 6)
    assert ransac_hyp_cuda.LAUNCHES == before and not ransac_hyp_cuda._LIB.loaded


def test_library_links_the_scale_step_source(tmp_path, monkeypatch):
    """The kernel is a further source of the relative pose's library: a
    build gives ``scale_step.cu`` to nvcc as a further input after the
    flags, and a library older than that source alone is built again."""
    assert ransac_hyp_cuda._LIB.sources == [cuda_build.CSRC / "relpose_hyp.cu", cuda_build.CSRC / "scale_step.cu"]
    csrc, builds, bound = tmp_path / "csrc", [], []
    csrc.mkdir()
    for name in ("relpose_hyp.cu", "scale_step.cu", "small_linalg.cuh"):
        (csrc / name).write_text("")
        os.utime(csrc / name, (1000, 1000))

    def compile_source(source, out, extra=()):
        builds.append((source, list(extra)))
        out.write_bytes(b"")
        return ""

    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "compile_source", compile_source)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)

    def load():
        cuda_build.CudaLibrary("relpose_hyp", bound.append, extra_flags=("-fmad=false",), more=("scale_step",)).load()

    load()
    assert builds == [(csrc / "relpose_hyp.cu", ["-fmad=false", str(csrc / "scale_step.cu")])]
    os.utime(tmp_path / "librelpose_hyp.so", (2000, 2000))
    load()
    assert len(builds) == 1  # newer than every source
    os.utime(csrc / "scale_step.cu", (3000, 3000))
    load()
    assert len(builds) == 2 and bound == [str(tmp_path / "librelpose_hyp.so")] * 3


def test_kernel_wrapper_refuses_before_any_launch():
    """The wrapper's checks raise before a build or a launch: CPU tensors,
    a mixed type, a wrong shape, an output that is not contiguous."""
    case = sb.step_case("base")
    pose, scale, counts = torch.zeros(6, dtype=torch.float64), torch.zeros((), dtype=torch.float64), torch.zeros(
        2, dtype=torch.int32)

    def call(**over):
        a = {**case, **over}
        ransac_hyp_cuda.scale_step(*(a[n] for n in sb.ARG_NAMES[:6]), a["depth"], a["prev_pose"], a["prev_scale"],
                                   over.get("pose", pose), scale, counts)

    before = dict(ransac_hyp_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(ValueError, match="rvec"):
        call(rvec=case["rvec"].float())
    with pytest.raises(ValueError, match="depth"):
        call(depth=case["depth"][:-1])
    with pytest.raises(ValueError, match="points are torch.float16"):
        call(pts1=case["pts1"].half())
    assert ransac_hyp_cuda.LAUNCHES == before and not ransac_hyp_cuda._LIB.loaded


def test_agreement_rule():
    """``scale_step_bench.agreement``, at the float64 and the float32
    limits: gaps at half of each limit pass; a scale at twice its limit, a
    NaN pattern or a held flag that differs fails; in float64 so does a
    neighbouring ratio taken for the median (2e-4 apart)."""
    pose, depth = torch.zeros(6, dtype=torch.float64), torch.tensor([1.0, float("nan"), 2.0], dtype=torch.float64)
    ref = (pose, 1.0, depth, (3, 0))
    other = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)
    for tol in (sb.TOLERANCE, sb.TOLERANCE_F32):
        half = {k: v / 2 for k, v in tol.items()}
        assert sb.agreement((pose + half["pose"], 1.0 + half["scale"], depth * (1 + half["depth"]), (3, 0)), ref,
                            tol)["ok"]
        assert not sb.agreement((pose, 1.0 + 2 * tol["scale"], depth, (3, 0)), ref, tol)["ok"]
        assert not sb.agreement((pose, 1.0, other, (3, 0)), ref, tol)["ok"]
        assert not sb.agreement((pose, 1.0, depth, (3, 1)), ref, tol)["ok"]
    assert not sb.agreement((pose, 1.0 + 2e-4, depth, (3, 0)), ref)["ok"]  # float64 by default
    assert sb.work(128)["flops"] > 0 and sb.work(128)["bytes"] > 128 * 25
