"""The hand-written CUDA kernels (CLAHE, Lucas-Kanade, relative-pose
refinement, and the board geometry's BA Jacobians, PnP refinement and
calibration LM) against their plain PyTorch versions, and the paths that
run them, on the card. Skipped
without CUDA (the kernels have no CPU mode).

This file imports no JAX, so it also runs where JAX is absent, without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch.ops import clahe as tclahe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_kernels(img, tiles):
    """LUT bit-exact, apply within 1e-4 of the plain versions; each wrapper
    launched its kernel."""
    from meatmodeler_tpu_torch.ops import clahe_cuda

    before = dict(clahe_cuda.LAUNCHES)
    lut = clahe_cuda.clahe_lut(img, 3.5, tiles)
    lut_ref = tclahe.lut_reference(img, 3.5, tiles)
    out = clahe_cuda.clahe_apply(img, lut_ref, tiles)
    torch.cuda.synchronize()
    # Integer counts: the LUTs are exact.
    assert torch.equal(lut, lut_ref)
    torch.testing.assert_close(out, tclahe.apply_reference(img, lut_ref, tiles), atol=1e-4, rtol=0)
    assert clahe_cuda.LAUNCHES["clahe_lut"] == before["clahe_lut"] + 1
    assert clahe_cuda.LAUNCHES["clahe_apply"] == before["clahe_apply"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,tiles", [((4, 540, 960), (8, 8)), ((2, 67, 120), (8, 8)), ((1, 64, 80), (4, 4))]
)
def test_cuda_kernels_match_reference(cuda, shape, tiles):
    from meatmodeler_tpu_torch.ops import clahe_cuda

    img = torch.from_numpy(
        np.random.default_rng(11).integers(0, 256, size=shape).astype(np.float32)
    ).to(cuda)
    before = dict(clahe_cuda.LAUNCHES)
    _check_kernels(img, tiles)
    torch.testing.assert_close(
        tclahe.clahe(img, tiles=tiles), tclahe.clahe_reference(img, tiles=tiles), atol=1e-4, rtol=0
    )
    assert clahe_cuda.LAUNCHES["clahe_lut"] == before["clahe_lut"] + 2
    assert clahe_cuda.LAUNCHES["clahe_apply"] == before["clahe_apply"] + 2


def _edge_image(case):
    """(image as numpy float32, tiles) of one edge case of the kernels."""
    rng = np.random.default_rng(13)
    if case == "flat":
        # One value everywhere: every lane of a warp in one bin, and the
        # whole tile over the clip limit.
        return np.full((3, 180, 320), 135.0, np.float32), (8, 8)
    if case == "two_tone_checker":
        yy, xx = np.mgrid[0:540, 0:960]
        board = np.where(((yy // 60) + (xx // 60)) % 2 == 0, 235.0, 20.0)
        return np.broadcast_to(board, (2, 540, 960)).astype(np.float32), (8, 8)
    if case.startswith("unaligned"):
        return rng.integers(0, 256, size=(2, 67, 121)).astype(np.float32), (8, 8) if case.endswith("8") else (4, 4)
    if case == "out_of_range_and_halves":
        # Below 0, above 255, and x.5 values (round half to even).
        vals = np.concatenate([rng.uniform(-40, 300, 4000), np.arange(256) + 0.5, [-0.5, 255.5, 0.49999997]])
        return rng.choice(vals, size=(2, 96, 128)).astype(np.float32), (8, 8)
    if case == "several_small_tiles":
        # 8x8-pixel tiles, a warp each: 25 tiles per image, so the last block
        # of 8 tiles is partly empty.
        return rng.integers(0, 256, size=(3, 40, 40)).astype(np.float32), (5, 5)
    shape = {"keyframes": (22, 540, 960), "pass1_chunk": (32, 180, 320), "pass1_last_chunk": (12, 180, 320)}[case]
    return rng.integers(0, 256, size=shape).astype(np.float32), (8, 8)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case",
    [
        "flat", "two_tone_checker", "unaligned_tiles8", "unaligned_tiles4", "out_of_range_and_halves",
        "several_small_tiles", "keyframes", "pass1_chunk", "pass1_last_chunk",
    ],
)
def test_cuda_kernels_edge_cases(cuda, case):
    img, tiles = _edge_image(case)
    _check_kernels(torch.from_numpy(np.ascontiguousarray(img)).to(cuda), tiles)


@pytest.mark.gpu
def test_cuda_kernels_reject_bad_input(cuda):
    from meatmodeler_tpu_torch.ops import clahe_cuda

    with pytest.raises(ValueError, match="float32"):
        clahe_cuda.clahe_lut(torch.zeros(1, 32, 32, dtype=torch.float16, device=cuda), 3.5, (4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        clahe_cuda.clahe_lut(torch.zeros(1, 32, 64, device=cuda)[:, :, ::2], 3.5, (4, 4))
    with pytest.raises(ValueError, match="bad LUT"):
        clahe_cuda.clahe_apply(torch.zeros(1, 32, 32, device=cuda), torch.zeros(1, 8, 256, device=cuda), (4, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["grey_chunk", "lab_lightness"])
def test_cuda_kernels_on_detector_path_inputs(cuda, source):
    """The video-alone path's two CLAHE inputs: a pass-1 chunk of uint8
    greys (32, 180, 320) and keyframes' non-integer LAB lightness."""
    from meatmodeler_tpu_torch.ops import color

    rng = np.random.default_rng(12)
    if source == "grey_chunk":
        img = torch.from_numpy(rng.integers(0, 256, size=(32, 180, 320)).astype(np.float32)).to(cuda)
    else:
        bgr = torch.from_numpy(rng.integers(0, 256, size=(3, 540, 960, 3)).astype(np.uint8)).to(cuda)
        img = color.bgr_to_lab(bgr)[..., 0].contiguous()
    _check_kernels(img, (8, 8))


@pytest.mark.gpu
def test_detector_path_ops_on_cuda_match_cpu(cuda):
    """Board detection, Shi-Tomasi corners and LK give the same answers on
    the card as the CPU path the parity tests hold to the JAX package."""
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.ops import board_detect, chessboard, features, klt

    frames, _, _ = render_sequence(TurntableScene(), 2, seed=1)
    grey = torch.from_numpy((frames[..., 0] * 0.114 + frames[..., 1] * 0.587 + frames[..., 2] * 0.299).astype(np.float32))
    det_c = board_detect.find_chessboard_device(grey)
    det_g = board_detect.find_chessboard_device(grey.to(cuda))
    assert det_g.ok.tolist() == det_c.ok.tolist() == [True, True]
    for cg, cc in zip(det_g.corners.cpu().numpy(), det_c.corners.numpy()):
        a, b = chessboard.canonicalize_corners(cg, (4, 3)), chessboard.canonicalize_corners(cc, (4, 3))
        assert min(np.abs(a - b).max(), np.abs(a[::-1] - b).max()) <= 1e-3
    gf_c = features.good_features(grey, max_corners=128)
    gf_g = features.good_features(grey.to(cuda), max_corners=128)
    assert torch.equal(gf_g.mask.cpu(), gf_c.mask)
    assert torch.equal(gf_g.xy.cpu()[gf_c.mask], gf_c.xy[gf_c.mask])
    pyr_c = [klt.build_pyramid(g, 4) for g in grey]
    pyr_g = [[p.to(cuda) for p in pyr] for pyr in pyr_c]
    flow_c = klt.lucas_kanade(pyr_c[0], pyr_c[1], gf_c.xy[0], win=15, levels=4, max_iters=10, point_mask=gf_c.mask[0])
    flow_g = klt.lucas_kanade(pyr_g[0], pyr_g[1], gf_c.xy[0].to(cuda), win=15, levels=4, max_iters=10, point_mask=gf_c.mask[0].to(cuda))
    assert torch.equal(flow_g.status.cpu(), flow_c.status)
    # The card sums each window in another order. A point whose last update
    # sits at the eps freeze threshold (0.01 px) can take or skip that one
    # update, so single points agree to eps; the bulk agrees to rounding.
    diff = (flow_g.points.cpu()[flow_c.status] - flow_c.points[flow_c.status]).abs()
    assert float(diff.max()) <= 0.01
    assert float(diff.median()) <= 1e-4


def check_lk(prev, curr, pts, mask, flow, s):
    """The kernel (one launch) against the plain version on the card:
    status and NaN patterns equal; the held points (all, or the live ones
    where the call is seeded with offsets) within eps with the median
    within 1e-4; errors
    within 1e-4 where the points agree to 1e-4 (``tools/klt_bench``'s
    ``held_entries`` and ``lk_agreement`` say why). The dispatch gives
    bit for bit what the wrapper gives."""
    from meatmodeler_tpu_torch.ops import klt, klt_cuda
    from meatmodeler_tpu_torch.tools.klt_bench import held_entries, lk_agreement, lk_kernel

    before = klt_cuda.LAUNCHES["lk_track"]
    got = klt.lucas_kanade(prev, curr, pts, point_mask=mask, initial_flow=flow, **s)
    torch.cuda.synchronize()
    assert klt_cuda.LAUNCHES["lk_track"] == before + 1
    res, _, _ = lk_kernel(prev, curr, pts, mask, flow, s)
    ref = klt.lucas_kanade_reference(prev, curr, pts, point_mask=mask, initial_flow=flow, **s)
    for x, y in zip(got, res):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    a = lk_agreement(got, ref, held_entries(pts, mask, flow))
    assert a["status_equal"] and a["nan_equal"], a
    assert a["max_point"] <= s["eps"] and a["median_point"] <= 1e-4, a
    assert a["max_error"] <= 1e-4, a
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["scan", "odometry", "two_view"])
def test_lk_kernel_matches_reference(cuda, case):
    from meatmodeler_tpu_torch.tools.klt_bench import lk_case

    check_lk(*lk_case(case, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flat", "masked", "scan_edges", "two_view_edges", "ragged", "deep_edges"])
def test_lk_kernel_edge_cases(cuda, case):
    """A flat image (G singular everywhere), half the points masked, points
    on, beyond and far outside the border and NaN points (and a NaN
    offset), 129 points, and the edge points at win 31 through 8 levels."""
    from meatmodeler_tpu_torch.tools.klt_bench import lk_case

    prev, curr, pts, mask, flow, s = lk_case(case, cuda)
    got = check_lk(prev, curr, pts, mask, flow, s)
    if case == "flat":
        assert not got.status.any() and torch.equal(got.points, pts)
    if case.endswith("_edges"):
        assert not got.status[12:19].any()


@pytest.mark.gpu
def test_lk_kernel_frozen_point_stays_bit_identical(cuda):
    """The kernel leaves a point's loop once it freezes, and every lane
    decides alike from the same butterfly sums: a point whose result did
    not change from max_iters k to k + 1 keeps it, bit for bit, through
    any number of further iterations."""
    from meatmodeler_tpu_torch.ops import klt_cuda
    from meatmodeler_tpu_torch.tools.klt_bench import lk_case

    prev, curr, pts, mask, _, _ = lk_case("scan", cuda)
    runs = [klt_cuda.lk_track(prev, curr, pts, 21, 1, k, 0.01, point_mask=mask)[0].cpu() for k in range(1, 17)]
    frozen_early = 0
    for k in range(len(runs) - 5):
        frozen = (runs[k] == runs[k + 1]).all(dim=1)
        frozen_early += int(frozen.sum()) if k < 6 else 0
        for j in range(2, 6):
            assert torch.equal(runs[k + j][frozen], runs[k][frozen])
    assert frozen_early > 0


@pytest.mark.gpu
def test_lk_kernel_rejects_bad_input(cuda):
    from meatmodeler_tpu_torch.ops import klt, klt_cuda
    from meatmodeler_tpu_torch.tools.klt_bench import lk_case

    prev, curr, pts, mask, _, _ = lk_case("scan", cuda)
    with pytest.raises(ValueError, match="float32"):
        klt.lucas_kanade([p.double() for p in prev], [p.double() for p in curr], pts, levels=4)
    with pytest.raises(ValueError, match="windows"):
        klt.lucas_kanade(prev, curr, pts, win=33)
    with pytest.raises(ValueError, match="contiguous"):
        klt.lucas_kanade([p.t() for p in prev], [p.t() for p in curr], pts)
    with pytest.raises(ValueError, match="shapes differ"):
        klt.lucas_kanade(prev, curr[1:] + curr[:1], pts)
    with pytest.raises(ValueError, match="points on"):
        klt_cuda.lk_track([p.cpu() for p in prev], curr, pts, 21, 4, 10, 0.01)
    with pytest.raises(ValueError, match="path"):
        klt_cuda.lk_track(prev, curr, pts, 21, 4, 10, 0.01, path=torch.zeros((len(pts), 4, 9, 2), device=cuda))


@pytest.mark.gpu
def test_keyframe_scan_flags_kernel_match_plain(cuda, monkeypatch):
    """A rendered clip through the device keyframe scan twice on the card,
    with the kernel and with the plain version: identical flags, and one
    kernel launch per scanned frame."""
    import dataclasses

    from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, KeyframeConfig
    from meatmodeler_tpu_torch.io import native_ops
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.ops import klt, klt_cuda
    from meatmodeler_tpu_torch.pipeline import _make_keyframe_scan

    config = dataclasses.replace(
        DEFAULT_CONFIG, keyframe=dataclasses.replace(KeyframeConfig(), max_corners=256, threshold=0.02)
    )
    frames, _, _ = render_sequence(TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0), 40, seed=0)
    greys = tclahe.clahe(torch.from_numpy(native_ops.bgr_to_grey_down(frames, 1)).to(cuda).float())

    def scan():
        init, scan_chunk = _make_keyframe_scan(config)
        carry, flags = init(greys[0]), []
        for i in range(0, 40, 8):
            carry, f = scan_chunk(carry, greys[i : i + 8], width_scale=1)
            flags.append(f.cpu())
        return torch.cat(flags)

    before = klt_cuda.LAUNCHES["lk_track"]
    with_kernel = scan()
    assert klt_cuda.LAUNCHES["lk_track"] == before + 40
    monkeypatch.setattr(klt, "lucas_kanade", klt.lucas_kanade_reference)
    plain = scan()
    assert int(with_kernel.sum()) >= 3
    assert torch.equal(with_kernel, plain)


def check_relpose(case, cuda):
    """The refinement kernel against its plain version at one seeded case
    (``tools/relpose_bench``): one launch per ``refine_relative_pose``
    call, NaN patterns equal, and the candidates float32 rounding does not
    decide (the plain version within 1e-5 of itself in float64) within
    1e-4; see ``test_torch_relpose_kernel.py`` for why the rest differ."""
    from meatmodeler_tpu_torch.geometry import ransac, ransac_cuda
    from meatmodeler_tpu_torch.tools.relpose_bench import determined, relpose_agreement, relpose_agrees, to_device

    args = to_device(case, cuda)
    before = ransac_cuda.LAUNCHES["refine_relpose"]
    got = ransac.refine_relative_pose(*args)
    assert ransac_cuda.LAUNCHES["refine_relpose"] == before + 1
    ref = ransac.refine_relative_pose_reference(*args)
    ref64 = ransac.refine_relative_pose_reference(*(a.double() if a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    a = relpose_agreement(got, ref, determined(ref, ref64))
    assert relpose_agrees(a, 1e-4), a
    assert torch.isfinite(torch.linalg.norm(got[1], dim=1)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odometry", "odometry_h", "bootstrap", "two_view", "odometry_24", "bootstrap_421"])
def test_relpose_kernel_matches_reference(cuda, case):
    from meatmodeler_tpu_torch.tools.relpose_bench import caller_case

    check_relpose(caller_case(case), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", ["small_angle", "near_pi", "zero_t", "all_masked", "nan_padding", "big_padding", "beyond_shared"]
)
def test_relpose_kernel_edge_cases(cuda, case):
    """The start's edge cases; 8192 slots with ~421 in the mask whose
    padding the compaction keeps: a NaN (every step refused, the starts
    returned) or 1e20 coordinates; and 12288 slots, whose compacted points
    the kernel keeps in global scratch instead of shared memory."""
    from meatmodeler_tpu_torch.tools.relpose_bench import relpose_case

    case_args = relpose_case(case)
    check_relpose(case_args, cuda)
    if case == "nan_padding":
        from meatmodeler_tpu_torch.geometry import ransac

        rv, _ = ransac.refine_relative_pose(*(torch.from_numpy(x).to(cuda) for x in case_args))
        assert torch.equal(rv.cpu(), torch.from_numpy(case_args[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bootstrap_421", "big_padding", "two_view", "beyond_shared"])
def test_relpose_kernel_compaction_drops_only_zero_slots(cuda, case):
    """The kernel on every slot gives bit for bit what it gives on the
    slots ``ransac_cuda.kept_slots`` keeps: the slots it drops are the ones
    that add exactly 0."""
    from meatmodeler_tpu_torch.geometry import ransac_cuda
    from meatmodeler_tpu_torch.tools.relpose_bench import caller_case, relpose_case, to_device

    rv, tv, p1, p2, m, k = to_device(caller_case(case) if case in ("bootstrap_421", "two_view") else relpose_case(case),
                                     cuda)
    kept = ransac_cuda.kept_slots(p1, p2, m, k)
    assert int(kept.sum()) < len(kept)
    every = ransac_cuda.refine_relpose(rv, tv, p1, p2, m, k)
    alone = ransac_cuda.refine_relpose(rv, tv, p1[kept], p2[kept], m[kept], k)
    for x, y in zip(every, alone):
        assert torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())


@pytest.mark.gpu
def test_relpose_kernel_rejects_bad_input(cuda):
    """Mistyped, misshapen or mixed-device inputs raise before any launch;
    no candidates launch nothing."""
    from meatmodeler_tpu_torch.geometry import ransac_cuda
    from meatmodeler_tpu_torch.tools.relpose_bench import caller_case, to_device

    args = list(to_device(caller_case("odometry_h"), cuda))
    before = ransac_cuda.LAUNCHES["refine_relpose"]
    for i, bad in ((0, args[0].double()), (2, args[2][:, :1]), (4, args[4].to(torch.uint8)), (5, args[5].cpu())):
        with pytest.raises(ValueError):
            ransac_cuda.refine_relpose(*args[:i], bad, *args[i + 1:])
    rv, tv = ransac_cuda.refine_relpose(args[0][:0], args[1][:0], *args[2:])
    assert rv.shape == (0, 3) and tv.shape == (0, 3)
    assert ransac_cuda.LAUNCHES["refine_relpose"] == before


def _two_view_scene(n=300, seed=0):
    """Spread points seen by two cameras (the port's projection), 0.5 px noise."""
    from meatmodeler_tpu_torch.geometry import projection

    rng = np.random.default_rng(seed)
    k = torch.tensor([[700.0, 0, 320], [0, 700.0, 240], [0, 0, 1]])
    pts = torch.from_numpy((rng.normal(size=(n, 3)) * 2 + [0, 0, 8]).astype(np.float32))
    cam1 = torch.tensor([0.02, 0.25, -0.03, -1.5, 0.1, 0.3])
    p1 = projection.project_points(pts, torch.zeros(6), k)
    p2 = projection.project_points(pts, cam1, k)
    noise = torch.from_numpy(rng.normal(scale=0.5, size=(2, n, 2)).astype(np.float32))
    return k, p1 + noise[0], p2 + noise[1]


@pytest.fixture
def cpu_draws(monkeypatch):
    """The same hypotheses on both devices: draws made on the CPU (a
    generator per call, seed 0), moved to the mask's device."""
    from meatmodeler_tpu_torch.geometry import ransac

    real = ransac.sample_subsets

    def draws(mask, num_hypotheses, size, generator):
        idx = real(mask.cpu(), num_hypotheses, size, torch.Generator().manual_seed(size))
        return idx.to(mask.device)

    monkeypatch.setattr(ransac, "sample_subsets", draws)


@pytest.mark.gpu
def test_estimate_relative_pose_on_cuda_matches_cpu(cuda, cpu_draws):
    """The LO-RANSAC bootstrap on the card against the port on the CPU, the
    same hypotheses on both: cuSOLVER's eigen/SVD signs and order may differ
    from LAPACK's, so rvec and unit tvec are held to 1e-3 and the inlier
    masks to 1% of the points."""
    from meatmodeler_tpu_torch.geometry import ransac

    k, p1, p2 = _two_view_scene()
    mask = torch.ones(p1.shape[0], dtype=torch.bool)
    mask[-10:] = False
    from meatmodeler_tpu_torch.geometry import ransac_cuda

    rv_c, tv_c, res_c = ransac.estimate_relative_pose(p1, p2, mask, k)
    before = ransac_cuda.LAUNCHES["refine_relpose"]
    rv_g, tv_g, res_g = ransac.estimate_relative_pose(p1.to(cuda), p2.to(cuda), mask.to(cuda), k.to(cuda))
    # Its 16 essential and 8 homography candidates in one launch.
    assert ransac_cuda.LAUNCHES["refine_relpose"] == before + 1
    torch.testing.assert_close(rv_g.cpu(), rv_c, atol=1e-3, rtol=0)
    torch.testing.assert_close(tv_g.cpu(), tv_c, atol=1e-3, rtol=0)
    assert int((res_g.inliers.cpu() != res_c.inliers).sum()) <= 3
    assert int(res_c.num_inliers) > 250


@pytest.mark.gpu
def test_chain_step_on_cuda_matches_cpu(cuda):
    """One step of the marker-free chain (re-triangulation, 2-start PnP,
    trimmed re-solve, in-chain BA) on the card against the CPU, from the
    same poses of keyframes 0 and 1: the same visible and PnP-inlier counts,
    the poses within 1e-3."""
    from meatmodeler_tpu_torch import pipeline
    from meatmodeler_tpu_torch.config import SolverConfig
    from meatmodeler_tpu_torch.geometry import projection

    rng = np.random.default_rng(1)
    n, f = 400, 4
    k = torch.tensor([[480.0, 0, 200], [0, 480.0, 150], [0, 0, 1]])
    pts = torch.from_numpy((rng.normal(size=(n, 3)) * [1.0, 1.0, 0.5] + [0, 0, 6]).astype(np.float32))
    cams = torch.tensor([[0.0, 0.05 * i, 0.0, -0.4 * i, 0.0, 0.03 * i] for i in range(f)])
    coords = projection.project_points(pts[:, None, :], cams[None], k)
    coords = coords + torch.from_numpy(rng.normal(scale=0.3, size=coords.shape).astype(np.float32))
    coords[:20, 2] += 15.0  # outliers in keyframe 2: the trimmed re-solve runs
    obs_mask = torch.from_numpy(rng.random((n, f)) < 0.9)
    obs_mask[:, :2] = True
    pidx, fidx = torch.nonzero(obs_mask, as_tuple=True)
    params = cams.clone()
    params[1, 3:] = cams[1, 3:] / torch.linalg.norm(cams[1, 3:])  # a unit baseline, as the bootstrap sets it
    params[2:] = params[1]
    known = torch.tensor([True, True, False, False])
    pose_cfg = SolverConfig(ftol=1e-8, max_iters=100)
    chain_cfg = SolverConfig(ftol=1e-6, max_iters=12)
    step = pipeline._make_chain_step(4.0, pose_cfg, chain_cfg)
    args = (params, known, torch.tensor(chain_cfg.init_lambda), 2, coords, obs_mask, coords[pidx, fidx], fidx, pidx, k)
    out_c = step(*args)
    out_g = step(*(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args))
    assert int(out_g[3]) == int(out_c[3]) and int(out_g[4]) == int(out_c[4])
    assert bool(out_g[1].cpu()[2]) and not bool(out_g[1].cpu()[3])
    torch.testing.assert_close(out_g[0].cpu()[:3], out_c[0][:3], atol=1e-3, rtol=0)


def _ba_batch(sizes, seed=0):
    """(V,) float64 BA problems of different sizes, padded and stacked as
    ``parallel.batch`` stacks them: points in front of cameras on an arc,
    0.5 px noise, perturbed starts."""
    from meatmodeler_tpu_torch.geometry import projection
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    rng = np.random.default_rng(seed)
    k = torch.tensor([[800.0, 0, 640], [0, 800.0, 360], [0, 0, 1]], dtype=torch.float64)
    probs = []
    for f, p in sizes:
        cams = torch.tensor([[0.0, 0.1 * i, 0.0, -1.0 * i, 0.0, 0.1 * i] for i in range(f)], dtype=torch.float64)
        pts = torch.from_numpy(rng.normal(size=(p, 3)) * 2 + [0, 0, 10])
        fidx, pidx = torch.meshgrid(torch.arange(f), torch.arange(p), indexing="ij")
        keep = torch.from_numpy(rng.random(f * p) < 0.8)
        fidx, pidx = fidx.reshape(-1)[keep], pidx.reshape(-1)[keep]
        obs = projection.project_points(pts[pidx], cams[fidx], k) + torch.from_numpy(rng.normal(scale=0.5, size=(len(fidx), 2)))
        probs.append((cams + torch.from_numpy(rng.normal(scale=0.01, size=cams.shape)), pts + 0.05, k, obs, fidx, pidx))
    caps = [max(pr[i].shape[0] for pr in probs) for i in (0, 1, 3)]

    def pad(x, n):
        return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])

    return bundle_adjust.BAProblem(
        cam_params=torch.stack([pad(pr[0], caps[0]) for pr in probs]),
        points=torch.stack([pad(pr[1], caps[1]) for pr in probs]),
        intrinsics=torch.stack([pr[2] for pr in probs]),
        obs=torch.stack([pad(pr[3], caps[2]) for pr in probs]),
        frame_idx=torch.stack([pad(pr[4], caps[2]) for pr in probs]),
        point_idx=torch.stack([pad(pr[5], caps[2]) for pr in probs]),
        mask=torch.stack([torch.arange(caps[2]) < len(pr[4]) for pr in probs]),
        weight=torch.stack([pad(torch.ones(len(pr[4]), dtype=torch.float64), caps[2]) for pr in probs]),
    )


@pytest.mark.gpu
def test_solve_ba_batch_on_cuda_matches_cpu(cuda):
    """The batched LM (one lane per video) on the card against the CPU, in
    float64 so every accept/stop decision is resolved far above rounding:
    the same iterations per lane, cameras and points within 1e-6 of each
    lane's scale."""
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    problem = _ba_batch([(5, 60), (8, 90), (3, 40)])
    res_c = bundle_adjust.solve_ba_batch(problem)
    res_g = bundle_adjust.solve_ba_batch(bundle_adjust.BAProblem(*(x.to(cuda) for x in problem)))
    assert res_g.iterations.cpu().tolist() == res_c.iterations.tolist()
    for name in ("cam_params", "points"):
        a, b = getattr(res_g, name).cpu(), getattr(res_c, name)
        scale = b.abs().amax(dim=(1, 2), keepdim=True)
        assert float(((a - b).abs() / scale).max()) <= 1e-6
    torch.testing.assert_close(res_g.rmse.cpu(), res_c.rmse, rtol=1e-8, atol=0)


@pytest.mark.gpu
def test_odometry_steps_on_cuda_match_cpu(cuda, cpu_draws):
    """Three steps of ``odometry.chain_poses`` on the card (CLAHE through
    the kernels, LK, LO-RANSAC with its refinement kernel, the scale step's
    kernel, one launch a step)
    against the CPU with the same hypotheses: track counts within 2 (LK's
    eps freeze, see ``test_detector_path_ops_on_cuda_match_cpu``),
    rotations within 1e-2
    rad and scales within 5e-2 relative. The tracked points differ at the
    eps level, which moves the LO-RANSAC's refined winner within the
    estimator's own noise (6.9e-3 rad on a 17-degree step, measured on an
    H100); both runs also follow the renderer's orbit within the JAX
    package's test bound, 6 degrees."""
    from meatmodeler_tpu_torch.geometry import ransac_cuda, ransac_hyp_cuda, so3
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.odometry import chain_poses
    from meatmodeler_tpu_torch.ops import clahe_cuda, klt_cuda

    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=0.5)
    frames, gt, _ = render_sequence(scene, 10, seed=3)
    frames, gt = frames[:4], gt[:4]
    res_c = chain_poses(frames, scene.intrinsics, device="cpu")
    before = dict(clahe_cuda.LAUNCHES)
    lk_before = klt_cuda.LAUNCHES["lk_track"]
    refine_before = ransac_cuda.LAUNCHES["refine_relpose"]
    scale_before = ransac_hyp_cuda.LAUNCHES["scale_step"]
    res_g = chain_poses(frames, scene.intrinsics, device="cuda")
    assert ransac_hyp_cuda.LAUNCHES["scale_step"] == scale_before + 3  # one per step
    assert clahe_cuda.LAUNCHES["clahe_lut"] == before["clahe_lut"] + 4
    assert klt_cuda.LAUNCHES["lk_track"] == lk_before + 3  # one launch per step
    # One per step: the essential candidates and the homography's together.
    assert ransac_cuda.LAUNCHES["refine_relpose"] == refine_before + 3
    assert np.abs(res_g.num_tracked - res_c.num_tracked).max() <= 2
    assert (res_g.num_tracked[1:] > 50).all()

    def rel(poses):
        r = so3.exp(torch.from_numpy(np.asarray(poses, np.float64)[:, :3]))
        return r @ r[0].T

    def angles(a, b):
        return torch.arccos(torch.clamp((torch.einsum("tij,tij->t", a, b) - 1.0) / 2.0, -1.0, 1.0))

    assert float(angles(rel(res_g.poses), rel(res_c.poses)).max()) < 1e-2
    assert float(angles(rel(res_g.poses), rel(gt)).max()) < np.radians(6.0)
    assert float(angles(rel(res_c.poses), rel(gt)).max()) < np.radians(6.0)
    np.testing.assert_allclose(res_g.scales[1:], res_c.scales[1:], rtol=5e-2)


@pytest.fixture
def two_gpus(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh_checks(devices):
    """The mesh's three other parts over ``devices`` against one device:
    the data-parallel batch (iterations equal, rmse within 1e-6 relative:
    the same per-lane arithmetic), tensor-parallel matching (good mask and
    indices exact), sharded preprocessing (within 1e-4, the kernels' apply
    tolerance), which launches both kernels on every shard."""
    from meatmodeler_tpu_torch.ops import clahe_cuda, matching
    from meatmodeler_tpu_torch.parallel import sharded
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    home = devices[0]
    mesh = sharded.make_mesh(data=len(devices), devices=devices)
    batch = bundle_adjust.BAProblem(*(x.to(home) for x in _ba_batch([(5, 60), (8, 90), (3, 40), (6, 50)])))
    one = bundle_adjust.solve_ba_batch(batch)
    res = sharded.solve_ba_batch(sharded.make_mesh(data=2, devices=devices), batch)
    assert res.iterations.tolist() == one.iterations.tolist()
    torch.testing.assert_close(res.rmse, one.rmse, rtol=1e-6, atol=0)

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(0, 2, size=(256, 256)).astype(np.int8)).to(home)
    t = torch.from_numpy(rng.integers(0, 2, size=(512, 256)).astype(np.int8)).to(home)
    t[100:164] = q[:64]
    qm = torch.ones(256, dtype=torch.bool, device=home)
    tm = torch.ones(512, dtype=torch.bool, device=home)
    idx, _, good = sharded.match_descriptors_tp(sharded.make_mesh(data=1, model=len(devices), devices=devices), q, t, qm, tm)
    ref = matching.match_descriptors(q, t, qm, tm, cross_check=False, max_matches=256)
    ref_good = torch.zeros(256, dtype=torch.bool, device=home)
    ref_good[ref.query_idx[ref.mask]] = True
    assert torch.equal(good, ref_good) and int(good.sum()) >= 64
    ref_idx = torch.full((256,), -1, dtype=torch.int64, device=home)
    ref_idx[ref.query_idx[ref.mask]] = ref.train_idx[ref.mask]
    assert torch.equal(idx[good], ref_idx[good])

    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(2 * len(devices), 90, 160, 3)).astype(np.uint8))
    before = dict(clahe_cuda.LAUNCHES)
    out = sharded.preprocess_sharded(mesh, frames)
    assert clahe_cuda.LAUNCHES["clahe_lut"] == before["clahe_lut"] + len(devices)
    assert clahe_cuda.LAUNCHES["clahe_apply"] == before["clahe_apply"] + len(devices)
    torch.testing.assert_close(out, tclahe.enhanced_grey(frames.to(home)), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_mesh_on_virtual_cuda_shards(cuda):
    """Four virtual shards of one card: the point-sharded solve against the
    unsharded one (``point_sharded_check``: in float64 the JAX package's
    bounds, rmse rtol 1e-4, equal iterations, cameras atol 1e-4, points
    atol 1e-3; in float32 the rmse), then the mesh's other parts."""
    from meatmodeler_tpu_torch.tools.profile_headline import point_sharded_check, synthetic_ba_problem

    point_sharded_check(synthetic_ba_problem(cuda, n_frames=6, n_points=600, n_obs=3000), [cuda] * 4)
    _mesh_checks([torch.device("cuda", torch.cuda.current_device())] * 4)


@pytest.mark.gpu
def test_clahe_launches_on_the_images_device(two_gpus):
    """An image on the second card: both kernels launch there (the wrapper
    makes the image's device current) and match their plain versions."""
    img = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(3, 540, 960)).astype(np.float32))
    _check_kernels(img.to(two_gpus[1]), (8, 8))


@pytest.mark.gpu
def test_mesh_over_distinct_gpus_through_nccl(two_gpus):
    """The collectives between distinct cards (NCCL), then the point-sharded
    solve and the mesh's other parts over every visible GPU."""
    from meatmodeler_tpu_torch.parallel import sharded
    from meatmodeler_tpu_torch.tools.profile_headline import point_sharded_check, synthetic_ba_problem

    parts = [torch.full((3, 4), float(i + 1), device=d) for i, d in enumerate(two_gpus)]
    total = float(sum(range(1, len(two_gpus) + 1)))
    for d, out in zip(two_gpus, sharded.all_reduce_sum(parts)):
        assert out.device == d and torch.equal(out.cpu(), torch.full((3, 4), total))
    for d, out in zip(two_gpus, sharded.all_gather(parts)):
        assert out.device == d and torch.equal(out.cpu(), torch.stack([p.cpu() for p in parts]))
    with pytest.raises(ValueError, match="distinct GPUs"):
        sharded.all_reduce_sum([parts[0], parts[0], parts[1]])
    point_sharded_check(synthetic_ba_problem(two_gpus[0], n_frames=6, n_points=600, n_obs=3000), two_gpus)
    _mesh_checks(two_gpus)


@pytest.mark.gpu
def test_process_batch_over_gpus(two_gpus):
    """``process_batch`` with a mesh over the GPUs (three clips: the batch
    pads to the data axis): the same keyframes per clip as the batch
    without, and its BA problems, solved again in float64 over the mesh
    and on one device, the same iterations and rmse within 1e-9 relative.
    (Two whole runs on the card differ by more: unordered scatter-adds
    upstream change the problems, and in float32 rounding can move where
    a lane stops: 3.5e-4 on one clip's rmse in one four-GPU run.)"""
    import dataclasses

    from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, MatcherConfig, OrbConfig, TrackConfig, VolumeConfig
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.parallel import sharded
    from meatmodeler_tpu_torch.parallel.batch import process_batch
    from meatmodeler_tpu_torch.solvers import bundle_adjust
    from meatmodeler_tpu_torch.tools.profile_headline import recording, with_dtype

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(DEFAULT_CONFIG.keyframe, max_corners=128, threshold=0.015),
        orb=OrbConfig(num_features=256, num_levels=2),
        matcher=MatcherConfig(max_matches=128),
        tracks=TrackConfig(max_tracks=512, max_keyframes=16),
        volume=VolumeConfig(voxel_resolution=24),
        frame_chunk=4,
        pass1_backend="host",
        pass2_enhance="grey",
    )
    scene = TurntableScene(image_size=(160, 120), focal=170.0, noise_sigma=0.5)
    clips, corners = zip(*((f, c) for f, _, c in (render_sequence(scene, 10, seed=s) for s in range(3))))
    one = process_batch(list(clips), config=config, known_corners=list(corners))
    with recording(sharded, "solve_ba_batch") as solves:
        over = process_batch(list(clips), config=config, known_corners=list(corners), mesh=sharded.make_mesh())
    (mesh, problem), _ = solves[0]
    assert mesh.shape["data"] == len(two_gpus) and problem.cam_params.shape[0] % len(two_gpus) == 0
    for a, b in zip(over, one):
        assert a.metrics["counters"]["keyframe_indices"] == b.metrics["counters"]["keyframe_indices"]
        assert np.isfinite(a.reprojection_rmse) and np.isfinite(a.points).all()
    problem = with_dtype(problem, torch.float64)
    res_mesh = sharded.solve_ba_batch(mesh, problem, config=config.solver)
    res_one = bundle_adjust.solve_ba_batch(problem, config=config.solver)
    assert res_mesh.iterations.tolist() == res_one.iterations.tolist()
    torch.testing.assert_close(res_mesh.rmse, res_one.rmse, rtol=1e-9, atol=0)


@pytest.mark.gpu
def test_band_shards_over_gpus(two_gpus):
    """``adjust_points`` with a budget half its (bucket-padded) Schur strip
    shards the points over two GPUs and lands where the one-GPU solve does
    (float64: rmse within 1e-4 relative, points within 5e-3, the JAX
    package's bounds for a banded ``adjust_points``); a budget needing more
    shards than there are GPUs raises."""
    from meatmodeler_tpu_torch.config import SolverConfig
    from meatmodeler_tpu_torch.geometry import projection
    from meatmodeler_tpu_torch.parallel import sharded
    from meatmodeler_tpu_torch.solvers import bundle_adjust
    from meatmodeler_tpu_torch.tools.profile_headline import synthetic_ba_problem, with_dtype

    pr = with_dtype(synthetic_ba_problem(two_gpus[0], n_frames=6, n_points=600, n_obs=3000), torch.float64)
    args = (projection.extrinsics_from_params(pr.cam_params), pr.intrinsics, pr.points, pr.obs, pr.frame_idx, pr.point_idx)
    strip = 2 * 768 * 8 * 18 * 8  # 600 -> 768 points, 6 -> 8 frames, float64
    seen = []
    real = sharded.solve_ba_point_sharded

    def spy(mesh, *a, **k):
        seen.append([row[0] for row in mesh.devices])
        return real(mesh, *a, **k)

    sharded.solve_ba_point_sharded = spy
    try:
        pts_b, _, res_b = bundle_adjust.adjust_points(*args, config=SolverConfig(hbm_strip_budget_bytes=strip // 2 + 1))
    finally:
        sharded.solve_ba_point_sharded = real
    pts_1, _, res_1 = bundle_adjust.adjust_points(*args)
    assert seen == [two_gpus[:2]]
    assert abs(float(res_b.rmse) - float(res_1.rmse)) <= 1e-4 * float(res_1.rmse)
    assert float((pts_b - pts_1).abs().max()) <= 5e-3
    with pytest.raises(ValueError, match="memory band"):
        bundle_adjust.adjust_points(*args, config=SolverConfig(hbm_strip_budget_bytes=strip // (len(two_gpus) + 1)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "case", ["ba_pose", "ba_global", "ba_lanes", "rvec0", "rvec1e-7", "rvec1e-3", "near_pi", "ba_wide"]
)
def test_obs_jacobians_kernel_matches_reference(cuda, case, dtype):
    """The BA Jacobian kernel against its plain version at the callers'
    shapes (the known path's pose-only and global problems, a batch of 8
    lanes, 8 lanes of 128 cameras past the kernel's shared coefficient
    table) and the rotation's edges (rvec 0, 1e-7, 1e-3, near pi):
    elementwise within 1e-5 (float32; 1e-12 in float64) of max(1, |J|) of
    the observation's block (``geometry_bench.jacobian_agreement``), NaN
    patterns equal; one launch a call."""
    from meatmodeler_tpu_torch.solvers import bundle_adjust, bundle_adjust_cuda
    from meatmodeler_tpu_torch.tools.geometry_bench import ba_case, ba_plain, jacobian_agreement, jacobians_agree

    args = ba_case(case, cuda, dtype)
    before = bundle_adjust_cuda.LAUNCHES["obs_jacobians"]
    got = bundle_adjust._obs_jacobians(args.cam, args.pts, args.intrinsics, None, args.fidx, args.pidx, args.mask,
                                       args.weight)
    assert bundle_adjust_cuda.LAUNCHES["obs_jacobians"] == before + 1
    a = jacobian_agreement(got, ba_plain(*args))
    assert jacobians_agree(a, 1e-5 if dtype == torch.float32 else 1e-12), a


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ba_pose", "ba_lanes", "ba_wide"])
def test_obs_jacobians_kernel_gives_nan_rows_for_bad_indices(cuda, case):
    """An observation whose camera or point index lies outside its lane's
    gets NaN rows (the plain version raises there), with the shared
    coefficient table (``ba_pose``, ``ba_lanes``) and without it
    (``ba_wide``); every other observation's rows are those of the same
    call with valid indices, bit for bit."""
    from meatmodeler_tpu_torch.solvers import bundle_adjust_cuda
    from meatmodeler_tpu_torch.tools.geometry_bench import ba_case

    args = list(ba_case(case, cuda))
    good = bundle_adjust_cuda.obs_jacobians(*args)
    fidx, pidx = args[3].clone(), args[4].clone()
    bad = torch.zeros(fidx.numel(), dtype=torch.bool, device=cuda)
    for flat, which, value in ((3, fidx, 10**6), (5, pidx, -1), (fidx.numel() - 1, fidx, -7)):
        which.view(-1)[flat] = value
        bad[flat] = True
    got = bundle_adjust_cuda.obs_jacobians(*args[:3], fidx, pidx, *args[5:])
    bad = bad.view(fidx.shape)
    for g, r in zip(got, good):
        assert bool(g[bad].isnan().all())
        torch.testing.assert_close(g[~bad], r[~bad], rtol=0, atol=0)


PNP_CASES = ["pnp", "pnp_batch", "pnp_single", "pnp_wide", "pnp_rvec0", "pnp_rvec1e-7", "pnp_rvec1e-3",
             "pnp_near_pi", "pnp_nan"]  # geometry_bench.COMPARE_PNP


@pytest.mark.gpu
@pytest.mark.parametrize("case", PNP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pnp_kernel_matches_reference(cuda, dtype, case):
    """The PnP kernel against its plain version at the known path's shape
    (both twins of 22 frames, 12 corners) and at ``geometry_bench``'s other
    PnP cases (a batch-row clip's 11 frames, one start, 54 corners of a 9x6
    board on 128 frames, starts at rvec 0, 1e-7, 1e-3 and near pi, NaN
    pixels in two frames): poses within 1e-4 on the starts whose plain
    float32 result lies within 1e-5 of float64 (all of them in float64),
    NaN patterns equal; ``refine_pose`` of one (6,) pose gives the batch's
    first pose; one launch a ``solve_pnp_batch``."""
    from meatmodeler_tpu_torch.geometry import pnp, pnp_cuda
    from meatmodeler_tpu_torch.tools.geometry_bench import (
        pnp_agreement, pnp_agrees, pnp_case, pnp_determined, pnp_plain, pnp_refine_case,
    )

    args = pnp_refine_case(case, cuda, dtype)
    got = pnp_cuda.pnp_refine(*args)
    ref = pnp_plain(*args)
    ref64 = pnp_plain(*(a.double() if isinstance(a, torch.Tensor) else a for a in args))
    held = pnp_determined(ref[0], ref64[0]) if dtype == torch.float32 else torch.ones(ref[0].shape[:2], dtype=torch.bool)
    a = pnp_agreement(got, ref, held)
    assert pnp_agrees(a), a
    one = pnp.refine_pose(args[0][0, 0], args[1], args[2][0], args[3])
    assert one.shape == (6,)
    torch.testing.assert_close(one, got[0][0, 0], rtol=0, atol=0, equal_nan=True)
    plane, obj, img, k = (torch.from_numpy(x).to(cuda, dtype) for x in pnp_case())
    before = pnp_cuda.LAUNCHES["pnp_refine"]
    poses = pnp.solve_pnp_batch(plane, (0, 2), obj, img, k)
    assert pnp_cuda.LAUNCHES["pnp_refine"] == before + 1 and poses.shape == (22, 6)


@pytest.mark.gpu
def test_shared_reciprocal_division_is_ieee(cuda):
    """``pinhole_jet.cuh``'s float division by a shared reciprocal (which
    ``pnp.cu`` divides with) gives IEEE division's bits on every pair it
    calls safe, random and next to rounding midpoints, and calls no NaN,
    infinity, denormal or out-of-range operand safe
    (``geometry_bench.quotient_check``)."""
    from meatmodeler_tpu_torch.tools.geometry_bench import quotient_check

    r = quotient_check(cuda, n=1 << 22)
    assert r["mismatches"] == 0 and r["unsafe_specials_marked_safe"] == 0, r
    assert r["safe"] > 2 * (1 << 22), r


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pnp_kernel_nan_frames(cuda, dtype):
    """NaN pixels in two frames (``geometry_bench.PNP_NAN``): the kernel's
    poses and costs have the plain version's NaN pattern (those frames',
    both twins), and every other frame's are bit for bit the clean call's."""
    from meatmodeler_tpu_torch.geometry import pnp_cuda
    from meatmodeler_tpu_torch.tools.geometry_bench import PNP_NAN, PNP_NAN_FRAMES, pnp_plain, pnp_refine_case

    args = pnp_refine_case(PNP_NAN, cuda, dtype)
    got = pnp_cuda.pnp_refine(*args)
    clean = pnp_cuda.pnp_refine(*pnp_refine_case("pnp", cuda, dtype))
    ref = pnp_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g.isnan(), r.isnan())
    bad = list(PNP_NAN_FRAMES)
    keep = [f for f in range(args[2].shape[0]) if f not in bad]
    assert bool(got[0][:, bad].isnan().all()) and bool(got[1][:, bad].isnan().all())
    assert torch.equal(got[0][:, keep], clean[0][:, keep]) and torch.equal(got[1][:, keep], clean[1][:, keep])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", ["calibrate", "calibrate_dist5", "calibrate_dist0", "calibrate_dist1", "calibrate_dist2",
             "calibrate_dist3", "calibrate_dist4", "calibrate_128", "calibrate_384"]
)
def test_calib_kernel_matches_reference(cuda, case):
    """The calibration LM kernel against its plain version at the known
    path's configuration (22 views, one focal, fixed centre, no distortion),
    at the general one with 0-5 distortion coefficients (two focals, a free
    centre, one masked view), and at 128 and 384 views of the general one
    (the last past the kernel's shared-memory budget): in float64 K and the rms within 1e-4
    relative, distortion and poses within 1e-4; in float32 the same where
    the plain float32 run lies within 1e-5 of float64
    (``geometry_bench.calib_determined``), equal NaN patterns everywhere.
    One launch a run."""
    from meatmodeler_tpu_torch.geometry import calibration, calibration_cuda
    from meatmodeler_tpu_torch.tools.geometry_bench import (
        calib_agreement, calib_agrees, calib_case, calib_determined, lm_args,
    )

    c = calib_case(case)
    a32, a64 = lm_args(c, cuda), lm_args(c, cuda, torch.float64)
    n_intr = a32[0].shape[0] - 6 * a32[1].shape[0]
    n_fp = (1 if c["single_focal"] else 2) + (0 if c["fix_principal_point"] else 2)
    points = int(np.sum(c["view_mask"]) if c["view_mask"] is not None else len(c["img"])) * c["img"].shape[1]
    ref32, ref64 = calibration.run_lm_reference(*a32), calibration.run_lm_reference(*a64)
    before = calibration_cuda.LAUNCHES["calib_lm"]
    got32, got64 = calibration_cuda.calib_lm(*a32), calibration_cuda.calib_lm(*a64)
    assert calibration_cuda.LAUNCHES["calib_lm"] == before + 2
    a = calib_agreement(got64, ref64, n_intr, n_fp, points, True)
    assert calib_agrees(a), a
    a = calib_agreement(got32, ref32, n_intr, n_fp, points, calib_determined(ref32, ref64))
    assert calib_agrees(a), a


@pytest.mark.gpu
def test_geometry_kernels_reject_bad_input(cuda):
    """Mistyped, misshapen or mixed-device inputs raise before any launch."""
    from meatmodeler_tpu_torch.geometry import calibration_cuda, pnp_cuda
    from meatmodeler_tpu_torch.solvers import bundle_adjust_cuda
    from meatmodeler_tpu_torch.tools.geometry_bench import ba_case, calib_case, lm_args, pnp_args, pnp_case

    launches = (dict(bundle_adjust_cuda.LAUNCHES), dict(pnp_cuda.LAUNCHES), dict(calibration_cuda.LAUNCHES))
    ba = list(ba_case("ba_global", cuda))
    for i, bad in ((0, ba[0].double()), (1, ba[1][:, :2]), (3, ba[3].int()), (5, ba[5].float()), (2, ba[2].cpu())):
        with pytest.raises(ValueError):
            bundle_adjust_cuda.obs_jacobians(*ba[:i], bad, *ba[i + 1:])
    pn = list(pnp_args(pnp_case(), cuda))
    for i, bad in ((0, pn[0][0]), (1, pn[1].double()), (2, pn[2][:, :5]), (3, pn[3].cpu())):
        with pytest.raises(ValueError):
            pnp_cuda.pnp_refine(*pn[:i], bad, *pn[i + 1:])
    lm = list(lm_args(calib_case(), cuda))
    for i, bad in ((0, lm[0][:-1]), (1, lm[1].double()), (2, lm[2].cpu())):
        with pytest.raises(ValueError):
            calibration_cuda.calib_lm(*lm[:i], bad, *lm[i + 1:])
    assert launches == (bundle_adjust_cuda.LAUNCHES, pnp_cuda.LAUNCHES, calibration_cuda.LAUNCHES)


@pytest.mark.gpu
def test_geometry_on_cuda_never_reaches_jacfwd(cuda, monkeypatch):
    """``calibrate``, ``solve_pnp_batch``, ``solve_ba``, ``solve_ba_batch``
    and ``pose_only_refine`` on CUDA tensors with ``jacfwd`` and the
    forward-AD lock made to raise: every Jacobian comes from a kernel."""
    from meatmodeler_tpu_torch.geometry import calibration, pnp, projection
    from meatmodeler_tpu_torch.solvers import bundle_adjust
    from meatmodeler_tpu_torch.tools.geometry_bench import calib_case, pnp_case
    from meatmodeler_tpu_torch.utils import numerics

    class Refuse:
        def __call__(self, *args, **kwargs):
            raise AssertionError("jacfwd reached on the card")

        def __enter__(self):
            raise AssertionError("the forward-AD lock taken on the card")

        def __exit__(self, *exc):
            return False

    for mod in (calibration, pnp, bundle_adjust):
        monkeypatch.setattr(mod, "jacfwd", Refuse())
    monkeypatch.setattr(numerics, "_FORWARD_AD_LOCK", Refuse())
    c = calib_case()
    res = calibration.calibrate(torch.from_numpy(c["img"]).to(cuda), torch.from_numpy(c["obj"]).to(cuda),
                                c["image_size"], num_dist=0, fix_principal_point=True, single_focal=True)
    assert torch.isfinite(res.rms)
    plane, obj, img, k = (torch.from_numpy(x).to(cuda) for x in pnp_case())
    assert torch.isfinite(pnp.solve_pnp_batch(plane, (0, 2), obj, img, k)).all()
    batch = bundle_adjust.BAProblem(*(x.to(cuda) for x in _ba_batch([(5, 60), (8, 90)])))
    assert torch.isfinite(bundle_adjust.solve_ba_batch(batch).rmse).all()
    one = bundle_adjust.BAProblem(*(x[0].to(cuda) for x in batch))
    assert torch.isfinite(bundle_adjust.solve_ba(one).rmse)
    cams = batch.cam_params[0, :3]
    pts = batch.points[0, :40].expand(3, 40, 3)
    obs = projection.project_points(pts, cams[:, None], batch.intrinsics[0])
    out = bundle_adjust.pose_only_refine(cams + 0.01, pts, batch.intrinsics[0], obs, torch.ones(3, 40, dtype=torch.bool,
                                                                                                  device=cuda))
    torch.testing.assert_close(out, cams, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_board_poses_on_cuda_match_cpu(cuda):
    """The known path's board geometry (``pipeline._board_poses``: sub-pixel
    corners, calibration, planar PnP, pose-only BA) on the card, through
    the three kernels, against the same run on the CPU: K and the two
    rmse counters within 1e-3 relative (float32 LMs stop a rounding apart),
    the refined extrinsics within 1e-2."""
    from meatmodeler_tpu_torch import pipeline
    from meatmodeler_tpu_torch.config import PipelineConfig
    from meatmodeler_tpu_torch.geometry import calibration_cuda, pnp_cuda
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.solvers import bundle_adjust_cuda
    from meatmodeler_tpu_torch.utils.profiling import Metrics

    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
    frames, _, corners = render_sequence(scene, 40, seed=0)
    pick = np.arange(0, 40, 5)
    grey = frames[pick].astype(np.float32) @ np.array([0.114, 0.587, 0.299], np.float32)
    kf_corners = [corners[i] for i in pick]
    out = {}
    before = (calibration_cuda.LAUNCHES["calib_lm"], pnp_cuda.LAUNCHES["pnp_refine"],
              bundle_adjust_cuda.LAUNCHES["obs_jacobians"])
    for dev in ("cpu", cuda):
        metrics = Metrics()
        ext, k, _ = pipeline._board_poses(PipelineConfig(), metrics, torch.from_numpy(grey).to(dev), kf_corners,
                                          400, 300, 1, torch.device(dev))
        out[str(dev)] = (ext.cpu(), k.cpu(), metrics.as_dict()["counters"])
    after = (calibration_cuda.LAUNCHES["calib_lm"], pnp_cuda.LAUNCHES["pnp_refine"],
             bundle_adjust_cuda.LAUNCHES["obs_jacobians"])
    # Two LM runs in calibrate, a PnP launch in its rescue pass and one in
    # the pose stage, at least one Jacobian launch in the pose-only BA.
    assert after[0] - before[0] == 2 and after[1] - before[1] == 2 and after[2] > before[2]
    (ext_c, k_c, c_c), (ext_g, k_g, c_g) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(k_g, k_c, rtol=1e-3, atol=0)
    torch.testing.assert_close(ext_g, ext_c, rtol=0, atol=1e-2)
    for name in ("calibration_rms_px", "pose_ba_rmse_px"):
        np.testing.assert_allclose(c_g[name], c_c[name], rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odometry", "bootstrap", "two_view", "nan_padding", "zero_t"])
def test_relpose_hyp_kernels_match_reference(cuda, case):
    """The hypothesis, cheirality and scoring kernels (``csrc/relpose_hyp.cu``)
    against their plain versions at the paths' seeded calls and the edges
    (a NaN slot out of the mask; zero-t candidates), float32 and float64,
    by ``relpose_bench.hyp_agreement``'s rules (held items: those float32
    rounding does not decide); each dispatch point on CUDA tensors is one
    launch of its kernel and gives that launch's result bit for bit."""
    from meatmodeler_tpu_torch.geometry import ransac, ransac_hyp_cuda
    from meatmodeler_tpu_torch.tools.relpose_bench import HYP_CALLS, hyp_agreement, hyp_agrees, hyp_case

    for name, args in hyp_case(case, device=cuda).items():
        kernel = HYP_CALLS[name]
        before = ransac_hyp_cuda.LAUNCHES[kernel]
        got = getattr(ransac, name)(*args)
        assert ransac_hyp_cuda.LAUNCHES[kernel] == before + 1
        once = getattr(ransac_hyp_cuda, name)(*args)
        for x, y in zip(got, once):
            if x is not None:
                torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
        a = hyp_agreement(name, args)
        assert hyp_agrees(name, a), (name, a)


@pytest.mark.gpu
def test_estimate_relative_pose_launches_each_kernel_once_without_syncs(cuda):
    """One estimate on the card: each hypothesis, cheirality and scoring
    kernel once (the homography's twice) and the refinement once, and no
    synchronizing operation that torch's sync debug mode sees."""
    import warnings

    from meatmodeler_tpu_torch.geometry import ransac, ransac_cuda, ransac_hyp_cuda

    k, p1, p2 = _two_view_scene()
    mask = torch.ones(p1.shape[0], dtype=torch.bool)
    args = [x.to(cuda) for x in (p1, p2, mask, k)]
    ransac.estimate_relative_pose(*args)
    torch.cuda.synchronize()
    before = dict(ransac_hyp_cuda.LAUNCHES), ransac_cuda.LAUNCHES["refine_relpose"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rv, tv, res = ransac.estimate_relative_pose(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    launched = {name: n - before[0][name] for name, n in ransac_hyp_cuda.LAUNCHES.items()}
    assert launched == {"essential_hypotheses": 1, "homography_hypotheses": 2, "recover_pose": 1,
                        "score_candidates": 1, "scale_step": 0}
    assert ransac_cuda.LAUNCHES["refine_relpose"] == before[1] + 1
    assert int(res.num_inliers) > 250 and torch.isfinite(rv).all()


@pytest.mark.gpu
def test_relpose_hyp_wrappers_reject_bad_input(cuda):
    """Mistyped, misshapen or mixed-device inputs raise before any launch;
    no hypotheses or candidates launch nothing."""
    from meatmodeler_tpu_torch.geometry import ransac_hyp_cuda
    from meatmodeler_tpu_torch.tools.relpose_bench import hyp_case

    case = hyp_case("odometry", device=cuda)
    before = dict(ransac_hyp_cuda.LAUNCHES)
    p1, p2, m, k, idx, thr2 = case["essential_hypotheses"]
    for bad in ((p1, p2, m, k.cpu(), idx, thr2), (p1, p2, m.float(), k, idx, thr2), (p1, p2, m, k, idx[:, :4], thr2),
                (p1, p2, m, k, idx, thr2.double())):
        with pytest.raises(ValueError):
            ransac_hyp_cuda.essential_hypotheses(*bad)
    es, counts = ransac_hyp_cuda.essential_hypotheses(p1, p2, m, k, idx[:0], thr2)
    assert es.shape == (0, 3, 3) and counts.shape == (0,)
    rv, tv, votes = ransac_hyp_cuda.recover_pose(case["recover_pose"][0][:0], *case["recover_pose"][1:])
    assert rv.shape == (0, 3) and votes.shape == (0, 4)
    assert ransac_hyp_cuda.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["known", "video", "odometry"])
def test_host_reads_all_fall_inside_spans(cuda, path, monkeypatch):
    """A small ``process`` call, known corners (host pass 1) or video alone
    (device pass 1 and detector), and a short ``chain_poses``: under
    ``MEATMODELER_SYNC_STAGES`` no synchronizing operation reaches the
    caller's warnings (each fell inside a span and counted there), and the
    ``host_reads:*`` counters sum to the synchronizing operations of the
    same call with sync debug mode held by the caller around the whole of it
    (the LM loops took the same iterations in both calls); the caller's
    mode is back after it."""
    import dataclasses
    import warnings

    from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, MatcherConfig, OrbConfig, TrackConfig, VolumeConfig
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.odometry import chain_poses
    from meatmodeler_tpu_torch.pipeline import process
    from meatmodeler_tpu_torch.utils.profiling import SYNC_WARNING

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(DEFAULT_CONFIG.keyframe, max_corners=256, threshold=0.02),
        orb=OrbConfig(num_features=768, num_levels=2),
        matcher=MatcherConfig(max_matches=512),
        tracks=TrackConfig(max_tracks=2048, max_keyframes=32),
        volume=VolumeConfig(voxel_resolution=48),
        frame_chunk=8,
    )
    if path == "known":
        config = dataclasses.replace(config, pass1_backend="host", pass2_enhance="grey")
    else:
        config = dataclasses.replace(config, chessboard=dataclasses.replace(config.chessboard, detector="device"))
    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
    frames, _, corners = render_sequence(scene, 40, seed=0)

    def run():
        if path == "odometry":
            return chain_poses(frames[:8], scene.intrinsics, device="cuda")
        return process(frames, config=config, known_corners=corners if path == "known" else None, device="cuda")

    def syncs(caught):
        return [w for w in caught if SYNC_WARNING in str(w.message)]

    run()  # warm: libraries, handles, allocator
    monkeypatch.delenv("MEATMODELER_SYNC_STAGES", raising=False)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plain = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    total = len(syncs(caught))
    monkeypatch.setenv("MEATMODELER_SYNC_STAGES", "1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spanned = run()
    assert torch.cuda.get_sync_debug_mode() == 0
    stray = syncs(caught)
    assert not stray, sorted({f"{w.filename}:{w.lineno}" for w in stray})
    counters = spanned.metrics["counters"]
    reads = {k: v for k, v in counters.items() if k.startswith("host_reads:")}
    print(f"{path}: {total} synchronizing operations; by span {reads}")
    iterations = {k: v for k, v in counters.items() if k.startswith("lm_iterations:")}
    assert iterations == {k: v for k, v in plain.metrics["counters"].items() if k.startswith("lm_iterations:")}
    assert total > 0 and sum(reads.values()) == total


@pytest.mark.gpu
@pytest.mark.parametrize("label", [
    "base", "slots_129", "slots_1500", "slots_9000", "ratios_9", "ratios_8", "ratios_7", "reseeded", "no_inliers",
    "bad_depths", "near_pi",
])
def test_scale_step_kernel_matches_plain_version(cuda, label):
    """``csrc/scale_step.cu`` against ``odometry.scale_step_reference`` in
    float64 at ``scale_step_bench.step_case``'s cases (129 slots, 1500
    beyond one block, 9000 with the sort in global memory, 9/8/7 qualifying
    slots, a reseed, no inliers, bad depths, a chained rotation near pi):
    the scale, the pose and the depths within 1e-9 (relative for the scale
    and the depths), the NaN pattern, the inlier count and the held flag
    exactly (``scale_step_bench.TOLERANCE``); one launch."""
    from meatmodeler_tpu_torch.geometry import ransac_hyp_cuda
    from meatmodeler_tpu_torch.tools import scale_step_bench as sb

    assert sb.CASES.count(label) == 1
    case = sb.step_case(label, device=cuda)
    before = ransac_hyp_cuda.LAUNCHES["scale_step"]
    got = sb.run_kernel(case)
    assert ransac_hyp_cuda.LAUNCHES["scale_step"] == before + 1
    a = sb.agreement(got, sb.run_plain({k: v.cpu() for k, v in case.items()}))
    assert a["ok"], a


@pytest.mark.gpu
def test_scale_step_kernel_matches_plain_version_at_odometry_steps(cuda):
    """The kernel at every step a ``chain_poses`` on the card recorded (one
    launch a step) against the plain version, each step's arguments in
    float64 (``scale_step_bench.TOLERANCE``) and as recorded, in float32,
    the path's type (``scale_step_bench.TOLERANCE_F32``)."""
    from meatmodeler_tpu_torch.geometry import ransac_hyp_cuda
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.tools import scale_step_bench as sb

    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=0.5)
    frames, _, _ = render_sequence(scene, 10, seed=3)
    before = ransac_hyp_cuda.LAUNCHES["scale_step"]
    _, steps = sb.record_steps(frames, scene.intrinsics, device="cuda")
    assert len(steps) == 9 and ransac_hyp_cuda.LAUNCHES["scale_step"] == before + 9
    assert all(s["pts1"].dtype == torch.float32 for s in steps)
    for t, s in enumerate(steps, start=1):
        for dtype, tol in ((torch.float64, sb.TOLERANCE), (torch.float32, sb.TOLERANCE_F32)):
            case = {k: (v if v.dtype == torch.bool else v.to(dtype)) for k, v in s.items()}
            a = sb.agreement(sb.run_kernel(case), sb.run_plain({k: v.cpu() for k, v in case.items()}), tol)
            assert a["ok"], (t, dtype, a)


@pytest.mark.gpu
def test_odometry_short_clip_reads_the_host_twice_a_step(cuda, monkeypatch):
    """A short ``chain_poses`` under ``MEATMODELER_SYNC_STAGES``: the scale
    step reads nothing a step (``host_reads:odometry_scale`` is the record's
    one read after the last step), the relative pose nothing beyond K's
    upload, and the clip at most 2 a step (a frame's upload and LK's
    survivor count) besides frame 0's upload, K's upload, the first seed's
    and the record's read."""
    from meatmodeler_tpu_torch.geometry import ransac_hyp_cuda
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.odometry import chain_poses

    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
    frames, _, _ = render_sequence(scene, 8, seed=0)
    chain_poses(frames, scene.intrinsics, device="cuda")  # warm
    monkeypatch.setenv("MEATMODELER_SYNC_STAGES", "1")
    before = ransac_hyp_cuda.LAUNCHES["scale_step"]
    res = chain_poses(frames, scene.intrinsics, device="cuda")
    steps = len(frames) - 1
    assert ransac_hyp_cuda.LAUNCHES["scale_step"] == before + steps
    reads = {k[len("host_reads:"):]: v for k, v in res.metrics["counters"].items() if k.startswith("host_reads:")}
    print(f"host reads of a {len(frames)}-frame clip by span: {reads}")
    assert sum(v for k, v in reads.items() if k.startswith("odometry_scale")) <= 1, reads
    assert reads.get("odometry_relpose", 0) <= 1, reads
    assert sum(reads.values()) <= 2 * steps + 4, reads


@pytest.mark.gpu
def test_batch_solve_reads_the_host_once_an_iteration(cuda, monkeypatch):
    """A 3-clip ``process_batch`` on the card, video alone (host pass 1, the
    device detector), under ``MEATMODELER_SYNC_STAGES``: the span
    ``batch_solve`` makes at most one host read an LM iteration (the "any
    lane active" flag) plus the final reads of the lanes' RMSE and
    iterations, so counting the lane-iterations adds none; its counters are
    the lanes' iterations."""
    import dataclasses

    from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, MatcherConfig, OrbConfig, TrackConfig, VolumeConfig
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.parallel.batch import process_batch

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(DEFAULT_CONFIG.keyframe, max_corners=256, threshold=0.02),
        orb=OrbConfig(num_features=768, num_levels=2),
        matcher=MatcherConfig(max_matches=512),
        tracks=TrackConfig(max_tracks=2048, max_keyframes=32),
        volume=VolumeConfig(voxel_resolution=48),
        frame_chunk=8,
        pass1_backend="host",
        pass2_enhance="grey",
        chessboard=dataclasses.replace(DEFAULT_CONFIG.chessboard, detector="device"),
    )
    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
    clips = [render_sequence(scene, 40, seed=seed)[0] for seed in range(3)]
    process_batch(clips, config=config, device="cuda")  # warm: libraries, handles, allocator
    monkeypatch.setenv("MEATMODELER_SYNC_STAGES", "1")
    results = process_batch(clips, config=config, device="cuda")
    counters = results[0].metrics["batch"]["counters"]
    reads = {k: v for k, v in counters.items() if k.startswith("host_reads:batch_solve")}
    iters = [r.metrics["counters"]["ba_iterations"] for r in results]
    print(f"batch_solve: {counters['lm_iterations:batch_solve']} iterations, lanes {iters}; reads {reads}")
    assert counters["lm_iterations:batch_solve"] == max(iters) > 0
    assert counters["lane_iterations:batch_solve"] == sum(iters) and counters["lanes:batch_solve"] == 3
    assert 0 < sum(reads.values()) <= counters["lm_iterations:batch_solve"] + 2


@pytest.fixture(scope="module")
def orb_inputs():
    """The stacks the paths hand ``orb.detect_and_compute`` on the card
    (``tools/orb_bench.record_inputs``): the known cell's keyframes, the
    video cell's LAB lightness, a batch-cell video's and two-view's image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from meatmodeler_tpu_torch.tools import orb_bench

    return orb_bench.record_inputs()


def _orb_edge_stack(case, device):
    """(stack, detect_and_compute keywords) of one edge case."""
    rng = np.random.default_rng(20)
    if case == "margin":  # pixel noise: corners everywhere, up to the margin
        return torch.from_numpy(rng.integers(0, 256, (2, 96, 128)).astype(np.float32)).to(device), {
            "max_features": 4000, "num_levels": 2}
    if case == "few":  # four bright squares: 16 corners against a budget of 600
        img = np.full((2, 120, 160), 40.0, np.float32)
        for y, x in ((30, 30), (30, 100), (70, 50), (75, 110)):
            img[:, y : y + 14, x : x + 14] = 200.0
        return torch.from_numpy(img).to(device), {"max_features": 1000, "num_levels": 2}
    if case == "flat":
        return torch.full((2, 80, 100), 135.0, device=device), {"max_features": 300, "num_levels": 3}
    if case == "single":
        return torch.from_numpy(rng.uniform(0, 255, (1, 100, 140)).astype(np.float32)).round().to(device), {
            "max_features": 500, "num_levels": 3}
    if case == "floor":  # 40 -> 33 -> 33: levels at the _PATCH + 2 floor
        return torch.from_numpy(rng.integers(0, 256, (3, 40, 40)).astype(np.float32)).to(device), {
            "max_features": 300, "num_levels": 3}
    raise ValueError(case)


def _hold_orb_to_plain_path(stack, kwargs):
    from meatmodeler_tpu_torch.tools import orb_bench

    settings = orb_bench._settings(kwargs)
    for lvl, (img, k, nxt) in enumerate(orb_bench.plain_levels(stack, *settings[:3])):
        a = orb_bench.level_agreement(img, k, nxt, settings[3], settings[4])
        print(f"level {lvl} {tuple(img.shape)} k {k}: {a}")
        assert a["ok"], (lvl, a)
    a = orb_bench.call_agreement(stack, **kwargs)
    print(f"whole call: {a}")
    assert a["ok"], a


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["known", "video", "batch", "two_view"])
def test_orb_kernels_match_plain_path_at_the_paths_inputs(cuda, orb_inputs, name):
    """Every level of each path's recorded stack: FAST flags equal, blurred
    levels bit-identical, downscales within 1e-4, Harris within 1e-5 of the
    largest |response|, 99.5% of keypoints common with every difference a
    near-tie at the k-th, angles within 1e-5 rad of the exact angle and of
    the plain angle beyond the plain path's own float32 rounding, bins equal
    off the edges, descriptors bit-identical where the bins agree
    (``orb_bench.RULES``, ``orb_bench._describe_agreement``)."""
    stack, kwargs = orb_inputs[name]
    print(f"{name}: {tuple(stack.shape)} {kwargs}")
    assert stack.shape[1:] == ((720, 1280) if name == "two_view" else (540, 960))
    _hold_orb_to_plain_path(stack, kwargs)


@pytest.mark.gpu
def test_orb_card_path_meets_the_jax_reference(cuda):
    """The card path on the two frames of ``data/orb_jax_reference.npz``
    against the JAX package's features of them, stored there (kept true to
    the JAX package by ``tests/test_torch_orb_kernels.py``): at least 99% of
    the slots identical, angles within 1e-4 rad, bins equal off the edges,
    descriptors bit-identical where the bins agree, responses within rtol
    1e-4 (``orb_bench.reference_agreement``)."""
    from pathlib import Path

    from meatmodeler_tpu_torch.ops import orb
    from meatmodeler_tpu_torch.tools import orb_bench

    with np.load(Path(__file__).parent / "data" / "orb_jax_reference.npz") as data:
        ref = {k: data[k] for k in data.files}
    frames = torch.from_numpy(ref["frames_u16"].astype(np.float32) / 256).to(cuda)
    a = orb_bench.reference_agreement(orb.detect_and_compute(frames, max_features=512, num_levels=3), ref)
    print(f"card path against the JAX package: {a}")
    assert a["ok"], a


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["margin", "few", "flat", "single", "floor"])
def test_orb_kernels_edge_cases(cuda, case):
    from meatmodeler_tpu_torch.ops import orb

    stack, kwargs = _orb_edge_stack(case, cuda)
    _hold_orb_to_plain_path(stack, kwargs)
    out = orb.detect_and_compute(stack, **kwargs)
    if case == "flat":
        assert not bool(out.mask.any()) and not bool(out.descriptors.any())
    if case == "few":
        assert 0 < int(out.mask[0].sum()) < kwargs["max_features"] // 2
    if case == "margin":
        x, y = out.xy[out.mask & (out.octave == 0)].unbind(-1)
        assert int(x.min()) >= 16 and int(y.min()) >= 16 and int(x.max()) <= 128 - 17 and int(y.max()) <= 96 - 17
        assert bool(((x == 16) | (x == 128 - 17) | (y == 16) | (y == 96 - 17)).any())


@pytest.mark.gpu
def test_orb_card_call_counts_levels_and_launches_without_host_reads(cuda):
    """One warm call on a (3, 120, 160) stack: each level through the three
    kernels once (``LAUNCHES``), ``orb_kernel_levels`` 4 on the span, and
    no synchronizing operation (sync debug mode "error")."""
    from meatmodeler_tpu_torch.ops import clahe_cuda, orb
    from meatmodeler_tpu_torch.utils.profiling import Metrics

    stack = torch.from_numpy(np.random.default_rng(21).integers(0, 256, (3, 120, 160)).astype(np.float32)).to(cuda)
    orb.detect_and_compute(stack, max_features=500, num_levels=4)  # warm: library, resident tables
    before = dict(clahe_cuda.LAUNCHES)
    metrics = Metrics()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with metrics.stage("pass2_orb"):
            orb.detect_and_compute(stack, max_features=500, num_levels=4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {k: clahe_cuda.LAUNCHES[k] - before[k] for k in before} == {"clahe_lut": 0, "clahe_apply": 0,
                                                                       "orb_level": 4, "orb_response": 4,
                                                                       "orb_describe": 4}
    assert metrics.as_dict()["counters"] == {"orb_kernel_levels:pass2_orb": 4}


@pytest.mark.gpu
def test_orb_wrappers_reject_bad_input(cuda):
    from meatmodeler_tpu_torch.ops import clahe_cuda

    img = torch.zeros((2, 64, 64), device=cuda)
    for bad in (img.cpu(), img.double(), img[0], img.transpose(1, 2)):
        with pytest.raises(ValueError):
            clahe_cuda.orb_response(bad, 20.0, margin=16)
    idx = torch.zeros((2, 5), dtype=torch.int64, device=cuda)
    resp = torch.zeros((2, 5), device=cuda)
    with pytest.raises(ValueError):
        clahe_cuda.orb_describe(img, img, idx.int(), resp, 0.2)
    with pytest.raises(ValueError):
        clahe_cuda.orb_describe(img, img, idx[:1], resp, 0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["known", "video"])
def test_process_runs_orb_on_the_kernels_without_host_reads(cuda, path, monkeypatch):
    """A small ``process`` call on the card with 4 ORB levels, known corners
    or video alone: ``orb_kernel_levels:pass2_orb`` is 4 and, warm and under
    ``MEATMODELER_SYNC_STAGES``, ``pass2_orb`` and its children read the
    host 0 times."""
    import dataclasses

    from meatmodeler_tpu_torch.config import DEFAULT_CONFIG, MatcherConfig, OrbConfig, TrackConfig, VolumeConfig
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.pipeline import process

    config = dataclasses.replace(
        DEFAULT_CONFIG,
        keyframe=dataclasses.replace(DEFAULT_CONFIG.keyframe, max_corners=256, threshold=0.02),
        orb=OrbConfig(num_features=768, num_levels=4),
        matcher=MatcherConfig(max_matches=512),
        tracks=TrackConfig(max_tracks=2048, max_keyframes=32),
        volume=VolumeConfig(voxel_resolution=48),
        frame_chunk=8,
    )
    if path == "known":
        config = dataclasses.replace(config, pass1_backend="host", pass2_enhance="grey")
    else:
        config = dataclasses.replace(config, chessboard=dataclasses.replace(config.chessboard, detector="device"))
    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=1.0)
    frames, _, corners = render_sequence(scene, 40, seed=0)
    corners = corners if path == "known" else None
    process(frames, config=config, known_corners=corners, device="cuda")  # warm
    monkeypatch.setenv("MEATMODELER_SYNC_STAGES", "1")
    counters = process(frames, config=config, known_corners=corners, device="cuda").metrics["counters"]
    orb_reads = {k: v for k, v in counters.items() if k.startswith("host_reads:pass2_orb")}
    print(f"{path}: orb_kernel_levels {counters.get('orb_kernel_levels:pass2_orb')}, reads {orb_reads}")
    assert counters["orb_kernel_levels:pass2_orb"] == 4
    assert sum(orb_reads.values()) == 0
