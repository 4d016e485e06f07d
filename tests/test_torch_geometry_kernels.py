"""The board geometry's three hand-written kernels, on the CPU: their plain
versions against the JAX package, the dispatch that keeps CPU tensors on
the plain versions, the wrappers' refusals, the bench's work counts, and
the card dispatch taking neither ``jacfwd`` nor the forward-AD lock.

- ``bundle_adjust._obs_jacobians`` (plain: ``_obs_jacobians_reference``,
  kernel ``csrc/ba_jac.cu``) against JAX's ``_obs_jacobians`` at the known
  path's pose-only problem, at rvec 0, 1e-7, 1e-3 and near pi, and over a
  lane axis (JAX's ``vmap``). Tolerance, relative to max(1, |J|) of each
  observation's (2, 9) block: 1e-9 in float64 (the same operations);
  1e-4 in float32, where the two packages' sin and cos differ by an ulp
  and the rotation columns cancel terms of the block's size (at rvec 1e-3
  the Taylor-free closed form loses five digits in either package).
- ``pnp.refine_pose`` / ``solve_pnp_batch`` (plain:
  ``refine_pose_reference``, kernel ``csrc/pnp.cu``) against JAX, single
  and batched, both twins: 1e-6 in float64, 1e-4 in float32; and from
  starts at the rotation's edges (rvec 0, 1e-7, 1e-3, near pi) in float64.
- ``calibrate`` (plain LM: ``calibration.run_lm_reference``, kernel
  ``csrc/calib.cu``) against JAX with 0 and 5 distortion coefficients,
  one and two focals, a masked view, in float64: K and the rms within
  1e-6 relative, the poses within 1e-5 (the LM's ftol stop can fall one
  iteration apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meatmodeler_tpu.geometry import calibration as jcal
from meatmodeler_tpu.geometry import pnp as jpnp
from meatmodeler_tpu.solvers import bundle_adjust as jba
from meatmodeler_tpu_torch.geometry import calibration, calibration_cuda, pnp, pnp_cuda
from meatmodeler_tpu_torch.ops import cuda_build
from meatmodeler_tpu_torch.solvers import bundle_adjust, bundle_adjust_cuda
from meatmodeler_tpu_torch.tools import geometry_bench
from meatmodeler_tpu_torch.tools.geometry_bench import (
    BA_EDGES,
    BA_OBS_OPS,
    PNP_POINT_OPS,
    PNP_SOLVE_OPS,
    ROT_OPS,
    ROT_VALUE_OPS,
    ba_case,
    ba_plain,
    ba_work,
    calib_agreement,
    calib_agrees,
    calib_case,
    calib_determined,
    calib_row_ops,
    calib_work,
    jacobian_agreement,
    jacobians_agree,
    lm_args,
    PNP_CASES,
    PNP_EDGES,
    PNP_NAN,
    PNP_NAN_FRAMES,
    PNP_WIDE,
    pnp_args,
    pnp_case,
    pnp_refine_case,
    pnp_work,
)
from meatmodeler_tpu_torch.utils import numerics

torch.set_num_threads(2)


def _np(x):
    return None if x is None else x.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["ba_pose", *BA_EDGES, "ba_lanes", "ba_wide"])
def test_obs_jacobians_reference_matches_jax(case, dtype):
    c = ba_case(case, "cpu", dtype)
    got = ba_plain(*c)
    obs = np.zeros(c.fidx.shape + (2,), dtype=c.cam.numpy().dtype)
    args = [jnp.asarray(_np(x)) for x in (c.cam, c.pts, c.intrinsics)] + [jnp.asarray(obs)]
    args += [jnp.asarray(_np(x)) for x in (c.fidx, c.pidx, c.mask)]
    if c.weight is not None:
        args.append(jnp.asarray(_np(c.weight)))
    fn = jax.vmap(jba._obs_jacobians) if c.cam.ndim == 3 else jba._obs_jacobians
    ref = tuple(torch.from_numpy(np.asarray(x)) for x in fn(*args))
    assert ref[0].dtype == dtype and got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    a = jacobian_agreement(got, ref)
    assert jacobians_agree(a, 1e-9 if dtype == torch.float64 else 1e-4), a


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_solve_pnp_batch_reference_matches_jax(dtype):
    """Both twins of every frame through ``solve_pnp_batch`` on the CPU,
    and ``refine_pose`` of one start single and batched, against JAX."""
    plane, obj, img, k = (x.astype(dtype) for x in pnp_case(frames=6))
    tol = 1e-6 if dtype == np.float64 else 1e-4
    ref = np.asarray(jpnp.solve_pnp_batch(jnp.asarray(plane), (0, 2), jnp.asarray(obj), jnp.asarray(img), jnp.asarray(k)))
    got = pnp.solve_pnp_batch(*(torch.from_numpy(x) for x in (plane,)), (0, 2), *(torch.from_numpy(x) for x in (obj, img, k)))
    np.testing.assert_allclose(got.numpy(), ref, atol=tol)
    starts = pnp_args((plane, obj, img, k), "cpu", torch.from_numpy(plane).dtype)[0]
    for f in range(2):
        one = np.asarray(jpnp.refine_pose(jnp.asarray(starts[1, f].numpy()), jnp.asarray(obj), jnp.asarray(img[f]),
                                          jnp.asarray(k)))
        np.testing.assert_allclose(pnp.refine_pose(starts[1, f], torch.from_numpy(obj), torch.from_numpy(img[f]),
                                                   torch.from_numpy(k)).numpy(), one, atol=tol)
    batched = pnp.refine_pose(starts[1], torch.from_numpy(obj), torch.from_numpy(img), torch.from_numpy(k))
    single = pnp.refine_pose(starts[1, 1], torch.from_numpy(obj), torch.from_numpy(img[1]), torch.from_numpy(k))
    np.testing.assert_allclose(batched[1].numpy(), single.numpy(), atol=tol)


@pytest.mark.parametrize("case", PNP_EDGES)
def test_refine_pose_reference_matches_jax_at_the_rotation_edges(case):
    """The plain refinement against JAX's ``refine_pose`` (float64, within
    1e-6) from starts at rvec 0, 1e-7 (the Taylor branch), 1e-3 and near pi,
    on the first four frames of each ``geometry_bench`` edge case."""
    poses, obj, img, k, iters, damping = pnp_refine_case(case, "cpu", torch.float64)
    starts, img = poses[0, :4], img[:4]
    ref = jax.vmap(lambda p, x: jpnp.refine_pose(p, jnp.asarray(obj.numpy()), x, jnp.asarray(k.numpy())))(
        jnp.asarray(starts.numpy()), jnp.asarray(img.numpy()))
    got = pnp.refine_pose_reference(starts, obj, img, k, iters, damping)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_pnp_cases_cover_the_kernels_edges():
    """``geometry_bench``'s PnP cases: the known path's call, a batch-row
    clip's 11 frames, one start; 54 corners (past one warp's 32 lanes) on
    128 frames; twin 0 of each edge case starting at rvec exactly 0, at
    |rvec| ~1e-7 (theta^2 under the Taylor branch's 1e-12), ~1e-3 and
    within 0.1 of pi, twin 1 at its planar twin; NaN pixels only in
    ``PNP_NAN_FRAMES``."""
    shapes = {"pnp": (2, 22, 12), "pnp_batch": (2, 11, 12), "pnp_single": (1, 1, 12), PNP_WIDE: (2, 128, 54)}
    for name in (*PNP_CASES, PNP_WIDE, *PNP_EDGES, PNP_NAN):
        poses, obj, img, k, iters, damping = pnp_refine_case(name)
        t, f, n = shapes.get(name, (2, 22, 12))
        assert tuple(poses.shape) == (t, f, 6) and tuple(obj.shape) == (n, 3) and tuple(img.shape) == (f, n, 2)
        assert tuple(k.shape) == (3, 3) and (iters, damping) == (10, 1e-8)
        assert bool(torch.isfinite(poses).all()) and (name == PNP_NAN or bool(torch.isfinite(img).all()))
    assert pnp_refine_case(PNP_WIDE)[1].shape[0] > 32
    theta = {name: pnp_refine_case(name, dtype=torch.float64)[0][0, :, :3].norm(dim=-1) for name in PNP_EDGES}
    assert bool((theta["pnp_rvec0"] == 0).all())
    assert bool((theta["pnp_rvec1e-7"] ** 2 < 1e-12).all()) and bool((theta["pnp_rvec1e-7"] > 0).all())
    assert bool(((theta["pnp_rvec1e-3"] > 4e-4) & (theta["pnp_rvec1e-3"] < 2e-3)).all())
    assert bool(((theta["pnp_near_pi"] > np.pi - 0.11) & (theta["pnp_near_pi"] < np.pi)).all())
    for name in PNP_EDGES:
        assert not torch.equal(pnp_refine_case(name)[0][1], pnp_refine_case(name)[0][0])
    img = pnp_refine_case(PNP_NAN)[2]
    nan_frames = torch.nonzero(img.isnan().flatten(1).any(1)).flatten().tolist()
    assert nan_frames == sorted(PNP_NAN_FRAMES) and bool(img[PNP_NAN_FRAMES[0]].isnan().all())
    assert int(img[PNP_NAN_FRAMES[1]].isnan().sum()) == 1
    with pytest.raises(ValueError, match="unknown PnP case"):
        pnp_refine_case("pnp_rvec1")


@pytest.mark.parametrize(
    "kwargs,masked",
    [
        (dict(num_dist=0, fix_principal_point=True, single_focal=True), False),
        (dict(num_dist=0, fix_principal_point=False, single_focal=False), False),
        (dict(num_dist=5, fix_principal_point=False, single_focal=False), True),
        (dict(num_dist=5, fix_principal_point=True, single_focal=True), True),
    ],
)
def test_calibrate_reference_matches_jax(kwargs, masked):
    c = calib_case("calibrate_dist5" if kwargs["num_dist"] else "calibrate", seed=3)
    img, obj = c["img"].astype(np.float64)[:10], c["obj"].astype(np.float64)
    mask = None
    if masked:
        img = np.concatenate([img, img[:2]])
        mask = np.arange(12) < 10
    ref = jcal.calibrate(jnp.asarray(img), jnp.asarray(obj), jnp.asarray(np.float64(c["image_size"])),
                         view_mask=None if mask is None else jnp.asarray(mask), **kwargs)
    got = calibration.calibrate(torch.from_numpy(img), torch.from_numpy(obj), c["image_size"],
                                view_mask=None if mask is None else torch.from_numpy(mask), **kwargs)
    np.testing.assert_allclose(got.intrinsics.numpy(), np.asarray(ref.intrinsics), rtol=1e-6)
    np.testing.assert_allclose(float(got.rms), float(ref.rms), rtol=1e-6)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist), atol=1e-5)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-5)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the three dispatch points run the plain versions: no
    library is built or loaded and no launch is counted."""

    def no_build():
        raise AssertionError("a CUDA library was asked for on CPU tensors")

    mods = (bundle_adjust_cuda, pnp_cuda, calibration_cuda)
    for mod in mods:
        monkeypatch.setattr(mod, "build", no_build)
    before = [dict(m.LAUNCHES) for m in mods]
    c = ba_case("ba_pose")
    obs = torch.zeros(c.fidx.shape + (2,))
    jc, jp = bundle_adjust._obs_jacobians(c.cam, c.pts, c.intrinsics, obs, c.fidx, c.pidx, c.mask)
    ref = bundle_adjust._obs_jacobians_reference(c.cam, c.pts, c.intrinsics, obs, c.fidx, c.pidx, c.mask)
    torch.testing.assert_close(jc, ref[0], rtol=0, atol=0)
    args = pnp_args(pnp_case(frames=4), "cpu")
    torch.testing.assert_close(pnp.refine_pose(args[0][0], *args[1:4]),
                               pnp.refine_pose_reference(args[0][0], *args[1:4]), rtol=0, atol=0)
    lm = lm_args(calib_case(), "cpu")
    for x, y in zip(calibration.run_lm(*lm), calibration.run_lm_reference(*lm)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert [dict(m.LAUNCHES) for m in mods] == before
    assert not any(m._LIB.loaded for m in mods)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """The wrappers launch on CUDA tensors only and refuse misshapen or
    mistyped inputs before asking for a library."""
    ba = list(ba_case("ba_pose"))
    with pytest.raises(ValueError, match="CUDA"):
        bundle_adjust_cuda.obs_jacobians(*ba)
    for i, bad in ((0, ba[0][:, :5]), (1, ba[1].double()), (2, ba[2][:2]), (3, ba[3].int()), (4, ba[4][:-1]),
                   (5, ba[5].float())):
        with pytest.raises(ValueError, match="expected|needs"):
            bundle_adjust_cuda.obs_jacobians(*ba[:i], bad, *ba[i + 1:])
    with pytest.raises(ValueError, match="expected"):
        bundle_adjust_cuda.obs_jacobians(*ba[:6], torch.ones(3))
    pn = list(pnp_args(pnp_case(frames=4), "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        pnp_cuda.pnp_refine(*pn)
    for i, bad in ((0, pn[0][0]), (1, pn[1][:, :2]), (2, pn[2][:2]), (3, pn[3].double())):
        with pytest.raises(ValueError, match="expected|needs"):
            pnp_cuda.pnp_refine(*pn[:i], bad, *pn[i + 1:])
    lm = list(lm_args(calib_case(), "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        calibration_cuda.calib_lm(*lm)
    for i, bad in ((0, lm[0][:-1]), (1, lm[1][..., :1]), (2, lm[2].double()), (8, torch.ones(3, dtype=torch.bool))):
        with pytest.raises(ValueError, match="expected|needs"):
            calibration_cuda.calib_lm(*lm[:i], bad, *lm[i + 1:])
    with pytest.raises(ValueError, match="num_dist"):
        calibration_cuda.calib_lm(*lm[:4], 6, *lm[5:])


def test_geometry_bench_work_counts():
    """The work the bound is computed from: what the function needs, as the
    module's note counts it (the rotation once per camera or start and
    iteration, no zero tangents, the call's own intrinsics and distortion
    terms, only what the masks keep)."""
    assert (ROT_VALUE_OPS, ROT_OPS, BA_OBS_OPS, PNP_POINT_OPS, PNP_SOLVE_OPS) == (44, 221, 158, 219, 162)
    w = ba_work(1, 22, 2000, 12000)
    assert w["flops"] == 22 * 221 + 12000 * 158
    assert ba_work(1, 22, 2000, 12000, active=11000)["flops"] == 22 * 221 + 11000 * 158
    assert w["bytes"] == (6 * 22 + 3 * 2000 + 9) * 4 + 12000 * (17 + 4) + 12000 * 72
    assert ba_work(8, 11, 400, 3000, 8, weighted=False)["bytes"] == 8 * ((66 + 1200 + 9) * 8 + 3000 * 17 + 3000 * 144)
    p = pnp_work(2, 22, 12)
    assert p["flops"] == 44 * (10 * (221 + 12 * 219 + 162) + 44 + 12 * 33)
    assert p["bytes"] == (2 * 44 * 6 + 36 + 22 * 24 + 9 + 44) * 4 and p["steps"] == 21
    assert calib_row_ops(1, 0) == 21 + 4 + 2 + 6 + 75 + 4 * (27 + 7 + 1)
    assert calib_row_ops(9, 5) == 21 + 28 + 4 + 2 + 37 + 18 + 75 + 4 * 5 + 4 * (27 + 63 + 45)
    c0, c8 = calib_work(22, 12, 1, 0, 0), calib_work(22, 12, 1, 0, 8)
    assert c0["flops"] == 22 * (44 + 12 * 31) and (c8["steps"], c8["barriers"]) == (33, 25)
    assert (c8["flops"] - c0["flops"]) % 8 == 0 and c8["bytes"] == (2 * 133 + 528 + 36 + 23) * 4
    assert calib_work(22, 12, 9, 5, 1)["flops"] > calib_work(22, 12, 1, 0, 1)["flops"]
    assert calib_work(22, 12, 1, 0, 8, views=21)["flops"] < c8["flops"]


def test_geometry_agreement_rules():
    """The Jacobian rule scales by each observation's block; the
    calibration rule holds K, rms, distortion and poses only where float32
    does not decide, and NaN patterns everywhere."""
    ref = (torch.tensor([[[100.0, 0.5]]]), torch.tensor([[[1.0]]]))
    assert jacobians_agree(jacobian_agreement((ref[0] + torch.tensor([0.0, 5e-4]), ref[1]), ref))
    assert not jacobians_agree(jacobian_agreement((ref[0] + torch.tensor([0.0, 2e-3]), ref[1]), ref))
    assert not jacobians_agree(jacobian_agreement((ref[0] * torch.nan, ref[1]), ref))
    theta = torch.tensor([750.0, 0.1, -0.2, 0.3, 1.0, 2.0, 20.0])
    ref = (theta, torch.tensor(10.0))
    close = (theta + torch.tensor([0.05, 0, 0, 0, 0, 0, 5e-5]), torch.tensor(10.0005))
    assert calib_agrees(calib_agreement(close, ref, 1, 1, 12, True))
    far = (theta + torch.tensor([0.5, 0, 0, 0, 0, 0, 0]), torch.tensor(10.0))
    assert not calib_agrees(calib_agreement(far, ref, 1, 1, 12, True))
    assert calib_agrees(calib_agreement(far, ref, 1, 1, 12, False))
    assert not calib_agrees(calib_agreement((far[0] * torch.nan, far[1]), ref, 1, 1, 12, False))
    assert calib_determined(ref, (theta.double(), torch.tensor(10.0, dtype=torch.float64)))
    assert not calib_determined(far, (theta.double(), torch.tensor(10.0, dtype=torch.float64)))


def test_card_dispatch_takes_neither_jacfwd_nor_the_lock(monkeypatch):
    """With the dispatch told that the tensors are on the card and the
    three wrappers replaced by stand-ins, ``calibrate`` (both LM runs and
    the rescue pass's PnP), ``solve_pnp_batch``, ``solve_ba``,
    ``solve_ba_batch`` and ``pose_only_refine`` run with ``jacfwd`` and the
    forward-AD lock made to raise: the card path reaches neither. (On the
    card, ``test_geometry_on_cuda_never_reaches_jacfwd`` does this with the
    kernels themselves.)"""
    calls = {"obs_jacobians": 0, "pnp_refine": 0, "calib_lm": 0}

    def obs_jacobians(cam, pts, intrinsics, fidx, pidx, mask, weight=None):
        calls["obs_jacobians"] += 1
        lead = fidx.shape
        return cam.new_zeros(lead + (2, 6)), cam.new_zeros(lead + (2, 3))

    def pnp_refine(poses, obj, img, k, iters=10, damping=1e-8):
        calls["pnp_refine"] += 1
        return poses, poses.new_zeros(poses.shape[:2])

    def calib_lm(theta0, *args):
        calls["calib_lm"] += 1
        return theta0, theta0.new_tensor(1.0), torch.tensor(0, dtype=torch.int32)

    class Refuse:
        def __call__(self, *args, **kwargs):
            raise AssertionError("jacfwd reached on the card path")

        def __enter__(self):
            raise AssertionError("the forward-AD lock taken on the card path")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(cuda_build, "on_card", lambda t: True)
    monkeypatch.setattr(bundle_adjust_cuda, "obs_jacobians", obs_jacobians)
    monkeypatch.setattr(pnp_cuda, "pnp_refine", pnp_refine)
    monkeypatch.setattr(calibration_cuda, "calib_lm", calib_lm)
    for mod in (calibration, pnp, bundle_adjust):
        monkeypatch.setattr(mod, "jacfwd", Refuse())
    monkeypatch.setattr(numerics, "_FORWARD_AD_LOCK", Refuse())

    c = calib_case()
    res = calibration.calibrate(torch.from_numpy(c["img"]), torch.from_numpy(c["obj"]), c["image_size"], num_dist=0,
                                fix_principal_point=True, single_focal=True)
    assert calls == {"obs_jacobians": 0, "pnp_refine": 1, "calib_lm": 2} and torch.isfinite(res.rms)
    plane, obj, img, k = (torch.from_numpy(x) for x in pnp_case(frames=4))
    assert pnp.solve_pnp_batch(plane, (0, 2), obj, img, k).shape == (4, 6)
    assert calls["pnp_refine"] == 2
    lanes = ba_case("ba_lanes")
    problem = bundle_adjust.BAProblem(lanes.cam, lanes.pts, lanes.intrinsics,
                                      torch.zeros(lanes.fidx.shape + (2,)), lanes.fidx, lanes.pidx, lanes.mask,
                                      lanes.weight)
    bundle_adjust.solve_ba_batch(problem)
    bundle_adjust.solve_ba(bundle_adjust.BAProblem(*(None if x is None else x[0] for x in problem)))
    b = ba_case("ba_pose")
    bundle_adjust.pose_only_refine(b.cam[:2], b.pts.expand(2, -1, -1), b.intrinsics, torch.zeros(2, 12, 2),
                                   torch.ones(2, 12, dtype=torch.bool))
    assert calls["obs_jacobians"] >= 3


def test_geometry_bench_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")
    assert geometry_bench.main([]) == 2


def test_geometry_bench_compare_refuses_without_cuda(tmp_path, monkeypatch):
    """``--compare`` (with or without ``--paths``) returns 2 where there is
    no CUDA, before it builds or renders anything; ``--paths`` alone is a
    usage error."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")

    def refuse(*args, **kwargs):
        raise AssertionError("geometry_bench built or rendered without CUDA")

    monkeypatch.setattr(cuda_build, "compile_source", refuse)
    monkeypatch.setattr(geometry_bench, "known_path_calls", refuse)
    monkeypatch.setattr(geometry_bench, "pnp_refine_case", refuse)
    assert geometry_bench.main(["--compare", str(tmp_path)]) == 2
    assert geometry_bench.main(["--compare", str(tmp_path), "--paths", "--ptxas", "--launches"]) == 2
    with pytest.raises(SystemExit) as exit_:
        geometry_bench.main(["--paths"])
    assert exit_.value.code == 2


def test_launches_by_caller_names_the_innermost_caller(monkeypatch):
    """``geometry_bench.launches_by_caller`` bills each ``obs_jacobians``
    launch to the innermost BA caller, inside the pose chain as "pose
    chain: <caller>", and restores every function it wraps."""
    from meatmodeler_tpu_torch import pipeline

    monkeypatch.setattr(bundle_adjust_cuda, "obs_jacobians", lambda *a, **k: None)
    monkeypatch.setattr(bundle_adjust, "pose_only_refine", lambda: bundle_adjust_cuda.obs_jacobians())
    monkeypatch.setattr(bundle_adjust, "adjust_points",
                        lambda: (bundle_adjust_cuda.obs_jacobians(), bundle_adjust.pose_only_refine()))
    monkeypatch.setattr(pipeline, "_chain_keyframe_poses",
                        lambda: (bundle_adjust.pose_only_refine(), bundle_adjust.adjust_points()))
    before = (bundle_adjust_cuda.obs_jacobians, bundle_adjust.adjust_points, pipeline._chain_keyframe_poses)

    def run():
        pipeline._chain_keyframe_poses()
        bundle_adjust.adjust_points()
        bundle_adjust_cuda.obs_jacobians()

    counts = geometry_bench.launches_by_caller(run)
    assert counts == {"pose chain: pose_only_refine": 2, "pose chain: adjust_points": 1, "adjust_points": 1,
                      "pose_only_refine": 1, "other": 1}
    assert (bundle_adjust_cuda.obs_jacobians, bundle_adjust.adjust_points, pipeline._chain_keyframe_poses) == before


@pytest.mark.parametrize("k", range(6))
def test_calib_dist_cases_fit_k_terms_to_one_scene(k):
    """``calibrate_dist<k>`` fits k distortion terms, two focals and a free
    centre to the pixels ``calibrate_dist5`` fits, with the last view
    masked; ``calibrate_128`` and ``calibrate_384`` are that layout at 128
    and 384 views."""
    c, five = calib_case(f"calibrate_dist{k}"), calib_case("calibrate_dist5")
    assert (c["num_dist"], c["single_focal"], c["fix_principal_point"]) == (k, False, False)
    np.testing.assert_array_equal(c["img"], five["img"])
    assert c["view_mask"].tolist() == [True] * 21 + [False]
    for views in (128, 384):
        wide = calib_case(f"calibrate_{views}")
        assert wide["img"].shape == (views, 12, 2) and wide["num_dist"] == 5
        assert wide["view_mask"].sum() == views - 1
    with pytest.raises(ValueError, match="unknown calibration case"):
        calib_case("calibrate_dist6")


def test_wide_ba_case_is_past_the_shared_coefficient_table():
    """``ba_wide``: 8 lanes of 128 cameras and 40 observation slots, so
    every 64-observation block of the Jacobian kernel spans lanes with more
    cameras than it has threads (the kernel then computes each thread's
    camera itself)."""
    c = ba_case("ba_wide")
    assert tuple(c.cam.shape) == (8, 128, 6) and tuple(c.fidx.shape) == (8, 40) and c.weight is not None
    n_obs, threads = c.fidx.shape[-1], 64
    for g0 in range(0, c.fidx.numel(), threads):
        last = min(g0 + threads, c.fidx.numel()) - 1
        assert (last // n_obs - g0 // n_obs + 1) * c.cam.shape[-2] > threads
    assert bool(((c.fidx >= 0) & (c.fidx < 128)).all()) and 0 < int(c.mask.sum()) < c.mask.numel()
