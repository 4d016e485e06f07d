"""The plain reference on the CPU at tiny sizes: it agrees with the
program's plain versions where the arithmetic is the same, and its
bfloat16 control does not."""

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch.geometry import projection
from meatmodeler_tpu_torch.io import native_ops
from meatmodeler_tpu_torch.ops import clahe as port_clahe
from meatmodeler_tpu_torch.solvers import bundle_adjust
from portbench.frozen.scene import TurntableScene, render_sequence
from portbench.reference import ba, enhance

SCENE = TurntableScene(image_size=(160, 120), focal=170.0, noise_sigma=1.5)


@pytest.fixture(scope="module")
def frames():
    return render_sequence(SCENE, 4, seed=3)[0]


def test_grey_keyframe_is_the_programs_decimation(frames):
    for scale in (1, 2, 3):
        ours = np.stack([enhance.grey_keyframe(f, scale) for f in frames])
        np.testing.assert_array_equal(ours, native_ops.bgr_to_grey_down(frames, scale))


def test_clahe_agrees_and_its_bfloat16_control_does_not(frames):
    grey = np.stack([enhance.grey_keyframe(f, 2) for f in frames])
    ours = enhance.enhance(grey, 3.5, (8, 8), "cpu")
    theirs = port_clahe.clahe(torch.from_numpy(grey).float())
    assert float((ours - theirs).abs().max()) < 1e-4
    control = enhance.enhance(grey, 3.5, (8, 8), "cpu", torch.bfloat16)
    assert float((control.double() - theirs.double()).abs().mean()) > 0.1


def test_lab_enhance_agrees_and_its_bfloat16_control_does_not(frames):
    bgr = np.stack([enhance.colour_keyframe(f, 2) for f in frames])
    ours = enhance.enhance(bgr, 3.5, (8, 8), "cpu")
    theirs = port_clahe.enhanced_grey(torch.from_numpy(bgr))
    gap = (ours.double() - theirs.double()).abs().mean(dim=(1, 2))
    assert float(gap.max()) < 1e-3  # a few pixels round into the neighbouring bin
    control = enhance.enhance(bgr, 3.5, (8, 8), "cpu", torch.bfloat16)
    assert float((control.double() - theirs.double()).abs().mean(dim=(1, 2)).min()) > 0.1


def _problem(seed=0, f=6, p=200, n=1200, noise=0.3):
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(p, 3, generator=g, dtype=torch.float64) * 2
    rvec = torch.randn(f, 3, generator=g, dtype=torch.float64) * 0.1
    rvec[0] = torch.tensor([3.1, 0.05, -0.02], dtype=torch.float64)  # near a half turn
    t = torch.randn(f, 3, generator=g, dtype=torch.float64)
    t[:, 2] += 10
    R = ba.exp_so3(rvec)
    k = torch.tensor([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]], dtype=torch.float64)
    fidx = torch.randint(0, f, (n,), generator=g)
    pidx = torch.randint(0, p, (n,), generator=g)
    obs = ba.project(pts[pidx], R[fidx], t[fidx], k) + noise * torch.randn(n, 2, generator=g, dtype=torch.float64)
    weight = 1.0 / 1.2 ** torch.randint(0, 3, (n,), generator=g).double()
    return {"R": ba.exp_so3(rvec + 0.01 * torch.randn(f, 3, generator=g, dtype=torch.float64)),
            "t": t + 0.01 * torch.randn(f, 3, generator=g, dtype=torch.float64),
            "points": pts + 0.02 * torch.randn(p, 3, generator=g, dtype=torch.float64),
            "K": k, "obs": obs, "fidx": fidx, "pidx": pidx, "weight": weight}, rvec


def test_ba_cost_is_the_programs():
    pr, rvec = _problem()
    cams = torch.cat([rvec, pr["t"]], dim=1)
    R = projection.extrinsics_from_params(cams)[:, :, :3]
    pr = dict(pr, R=R)
    r = bundle_adjust._residuals(cams, pr["points"], pr["K"], pr["obs"], pr["fidx"], pr["pidx"],
                                 torch.ones(len(pr["obs"]), dtype=torch.bool), pr["weight"])
    assert float(ba.cost(pr)) == pytest.approx(float(0.5 * (r * r).sum()), rel=1e-12)
    assert torch.allclose(ba.exp_so3(rvec), R, rtol=0, atol=1e-14)


def test_ba_gain_tells_a_converged_solve_from_others():
    pr, _ = _problem()
    assert ba.gain(pr) > 0.5  # the starting point
    R, t, points, rmse = ba.solve(pr, torch.float64, max_iters=100, ftol=1e-12)
    solved = dict(pr, R=R, t=t, points=points)
    assert ba.gain(solved) < 1e-9
    assert float(rmse) == pytest.approx(float(ba.rmse(solved)), rel=1e-12)
    # The same solution handed over as float32 rotation matrices, as the
    # program returns its cameras: rounding, not a step, separates them.
    as_f32 = dict(solved, R=R.float().double(), t=t.float().double(), points=points.float().double())
    assert ba.gain(as_f32) < 1e-6
    assert float(ba.rmse(as_f32)) == pytest.approx(float(rmse), rel=1e-6)
    half = dict(pr, obs=pr["obs"][::2], fidx=pr["fidx"][::2], pidx=pr["pidx"][::2], weight=pr["weight"][::2])
    R_h, t_h, points_h, _ = ba.solve(half, torch.float64, max_iters=100, ftol=1e-12)
    assert ba.gain(dict(pr, R=R_h, t=t_h, points=points_h)) > 0.05  # half the observations left out
    R_b, t_b, points_b, rmse_b = ba.solve(pr, torch.bfloat16)
    control = dict(pr, R=R_b.double(), t=t_b.double(), points=points_b.double())
    assert ba.gain(control) > 0.1
    assert abs(float(rmse_b) - float(ba.rmse(control))) / float(ba.rmse(control)) > 1e-3


def test_subpix_is_the_programs_and_its_step_vanishes_at_its_fixed_point(frames):
    from meatmodeler_tpu_torch.ops import chessboard

    from portbench.reference import board

    grey = np.stack([enhance.grey_keyframe(f, 1) for f in frames])
    img = enhance.enhance(grey, 3.5, (8, 8), "cpu")
    corners = torch.from_numpy(render_sequence(SCENE, 4, seed=3)[2]).float() + 0.4
    theirs = chessboard.refine_corners_subpix(img, corners, win=5, iters=30)
    ours = board.subpix(img, corners, 5, 30, 1e-3, torch.float64)
    assert float((ours - theirs.double()).abs().max()) < 1e-3
    assert float(board.subpix_step(img, theirs, 5).max()) < 2e-3
    assert float(board.subpix_step(img, corners, 5).max()) > 0.05  # unrefined
    control = board.subpix(enhance.enhance(grey, 3.5, (8, 8), "cpu", torch.bfloat16), corners, 5, 30, 1e-3,
                           torch.bfloat16)
    assert float(board.subpix_step(img, control.double(), 5).max()) > 0.05


def _board_problem(seed=0, views=8, focal=600.0, noise=0.2):
    from portbench.reference import board

    g = torch.Generator().manual_seed(seed)
    pts = board.board_points((4, 3), 2.0)
    rvec = torch.tensor([1.6, 0.0, 0.0], dtype=torch.float64) + 0.2 * torch.randn(views, 3, generator=g,
                                                                                   dtype=torch.float64)
    R = ba.exp_so3(rvec)
    t = torch.tensor([-3.0, 2.0, 18.0], dtype=torch.float64) + torch.randn(views, 3, generator=g, dtype=torch.float64)
    centre = torch.tensor([320.0, 240.0], dtype=torch.float64)
    cam = torch.einsum("bij,nj->bni", R, pts) + t[:, None]
    corners = focal * cam[..., :2] / cam[..., 2:3] + centre
    corners = corners + noise * torch.randn(corners.shape, generator=g, dtype=torch.float64)
    return {"R": R, "t": t, "focal": torch.tensor(focal, dtype=torch.float64), "centre": centre, "board": pts,
            "corners": corners}


def test_board_gain_tells_a_converged_board_from_others():
    from portbench.reference import board

    pr = _board_problem()
    R, t, focal = board.solve(pr, torch.float64, ftol=1e-14)
    solved = dict(pr, R=R, t=t, focal=focal)
    assert board.gain(solved) < 1e-9
    assert board.gain(dict(solved, focal=focal * 1.01)) > 0.1  # a focal length 1% off
    assert board.gain(dict(solved, t=t + 0.02)) > 0.1  # poses off
    R_b, t_b, focal_b = board.solve(pr, torch.bfloat16)
    assert board.gain(dict(pr, R=R_b.double(), t=t_b.double(), focal=focal_b.double())) > 0.01


def test_board_cost_is_the_programs_pose_refinement_cost():
    from portbench.reference import board

    pr = _board_problem(1)
    ext = torch.cat([pr["R"], pr["t"][:, :, None]], dim=2)
    k = torch.tensor([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], dtype=torch.float64)
    _, res = bundle_adjust.adjust_pose(ext, k, pr["corners"].reshape(-1, 2), pattern=(4, 3), side_length=2.0,
                                       config=bundle_adjust.SolverConfig(max_iters=0))
    cams = projection.params_from_extrinsics(ext)
    r = bundle_adjust._residuals(cams, board.board_points((4, 3), 2.0), k, pr["corners"].reshape(-1, 2),
                                 torch.arange(8).repeat_interleave(12), torch.arange(12).repeat(8),
                                 torch.ones(96, dtype=torch.bool), None)
    assert float(board.cost(pr)) == pytest.approx(float(0.5 * (r * r).sum()), rel=1e-9)


def _cloud(seed=0, n=600):
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(n, 3, generator=g, dtype=torch.float64)
    item = d / d.norm(dim=1, keepdim=True) * torch.tensor([2.0, 1.5, 1.8], dtype=torch.float64)
    item = item + torch.tensor([0.0, -1.8, 0.0], dtype=torch.float64)
    ground = torch.rand(n // 3, 3, generator=g, dtype=torch.float64) * torch.tensor([8.0, 0.0, 8.0]) - 4.0
    stray = torch.randn(5, 3, generator=g, dtype=torch.float64) * 6.0
    pts = torch.cat([item, ground, stray])
    angles = torch.linspace(0.0, 1.2, 6, dtype=torch.float64)
    proj = []
    for a in angles:
        R = ba.exp_so3(torch.tensor([0.0, float(a), 0.0], dtype=torch.float64))
        R = ba.exp_so3(torch.tensor([-0.5, 0.0, 0.0], dtype=torch.float64)) @ R
        t = torch.tensor([0.0, 0.0, 12.0], dtype=torch.float64)
        k = torch.tensor([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], dtype=torch.float64)
        proj.append(k @ torch.cat([R, t[:, None]], 1))
    return pts, torch.stack(proj)


def test_volume_reference_is_the_programs():
    from meatmodeler_tpu_torch import volume as port_volume

    from portbench.reference import volume

    pts, proj = _cloud()
    gate = torch.ones(pts.shape[0], dtype=torch.bool)
    gate[::7] = False
    theirs = port_volume.split_item_points(pts.float(), gate)
    ours = volume.item_mask(pts, gate)
    assert torch.equal(ours, theirs)
    kw = dict(image_size=(320, 240), resolution=32, num_directions=128, trim=5, dilation=3, grid_step=2,
              close_frac=0.015, vote_frac=0.9, trim_ref=300)
    hull, _ = port_volume.hull_and_carved_volume(pts.float(), theirs, proj.float(), torch.ones(6, dtype=torch.bool),
                                                 support_mask=theirs, **kw)
    args = (kw["image_size"], kw["resolution"], kw["num_directions"], kw["trim"], kw["trim_ref"], kw["dilation"],
            kw["grid_step"], kw["close_frac"], kw["vote_frac"])
    ref = volume.hull_volume(pts, ours, proj, *args, torch.float64)
    assert abs(float(hull) - ref) / ref < 1e-4
    control = volume.hull_volume(pts, ours, proj, *args, torch.bfloat16)
    assert abs(control - ref) / ref > 1e-3


def test_tracking_status_and_depth_scale():
    from meatmodeler_tpu_torch.ops import klt

    from portbench.reference import track

    scene = TurntableScene(image_size=(160, 120), focal=170.0, noise_sigma=0.5, show_board=False,
                           ground_texture=12.0)
    grey = render_sequence(scene, 2, seed=5, color=False)[0]
    img = enhance.enhance(np.asarray(grey), 3.5, (8, 8), "cpu")
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(64, 2, generator=g) * torch.tensor([160.0, 120.0])
    pts[:4] = torch.tensor([[-30.0, 5.0], [200.0, 60.0], [80.0, -40.0], [5.0, 5.0]])
    theirs = klt.lucas_kanade_reference(klt.build_pyramid(img[0], 3), klt.build_pyramid(img[1], 3), pts, win=9,
                                        levels=3, max_iters=10, eps=0.01)
    stack = track.pyramid(img.double(), 3)
    step = torch.zeros(64, dtype=torch.long)
    ours, ok = track.track([p[:-1] for p in stack], [p[1:] for p in stack], pts.double(), 9, 10, 0.01, step)
    assert torch.equal(ok, theirs.status) and not bool(ok[:3].any())
    # Where float32 decides when an update falls under eps, the two stop a
    # step apart: most points agree to float32's rounding, none by much.
    gap = (ours - theirs.points.double())[ok].norm(dim=1)
    assert float(gap.median()) < 1e-3 and float(gap.max()) < 0.1
    # Depth ratios: two pairs of one rigid motion give the ratio of their
    # translations.
    k = torch.tensor([[170.0, 0, 80], [0, 170.0, 60], [0, 0, 1]], dtype=torch.float64)
    x = torch.randn(40, 3, generator=g, dtype=torch.float64) + torch.tensor([0.0, 0.0, 10.0], dtype=torch.float64)
    R = ba.exp_so3(torch.tensor([0.0, 0.05, 0.0], dtype=torch.float64))
    t = torch.tensor([-1.0, 0.0, 0.1], dtype=torch.float64)

    def pix(p):
        h = p @ k.T
        return h[:, :2] / h[:, 2:]

    x2 = x @ R.T + t * 2.0  # the true step is twice the unit translation
    inl = torch.ones(40, dtype=torch.bool)
    s1, depth = track.depth_scale(k, R, t / t.norm(), pix(x), pix(x2), inl,
                                  torch.full((40,), float("nan"), dtype=torch.float64), 1.0, torch.float64)
    assert s1 == 1.0 and torch.allclose(depth, (x2[:, 2] / (2.0 * t.norm())), rtol=1e-9)
    x3 = x2 @ R.T + t * 3.0
    s2, _ = track.depth_scale(k, R, t / t.norm(), pix(x2), pix(x3), inl, depth * 2.0 * t.norm(), s1,
                              torch.float64)
    assert s2 == pytest.approx(3.0 * float(t.norm()), rel=1e-9)
