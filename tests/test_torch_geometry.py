"""Parity of the port's geometry with the JAX package on identical float32
inputs: so3, projection, distortion, homography, triangulation, planar PnP
and Zhang calibration. Tolerance: 1e-4 relative (or 1e-3 px for pixel
outputs) unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu.geometry import calibration as jcal
from meatmodeler_tpu.geometry import distortion as jdist
from meatmodeler_tpu.geometry import homography as jhom
from meatmodeler_tpu.geometry import pnp as jpnp
from meatmodeler_tpu.geometry import projection as jproj
from meatmodeler_tpu.geometry import so3 as jso3
from meatmodeler_tpu.geometry import triangulation as jtri
from meatmodeler_tpu_torch.geometry import calibration as tcal
from meatmodeler_tpu_torch.geometry import distortion as tdist
from meatmodeler_tpu_torch.geometry import homography as thom
from meatmodeler_tpu_torch.geometry import pnp as tpnp
from meatmodeler_tpu_torch.geometry import projection as tproj
from meatmodeler_tpu_torch.geometry import so3 as tso3
from meatmodeler_tpu_torch.geometry import triangulation as ttri
from meatmodeler_tpu_torch.testing import f32, pair, seeded_normal, tt

torch.set_num_threads(2)

K = np.array([[700.0, 0.0, 320.0], [0.0, 700.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def _rvecs(seed, n, near_pi=0):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0.0, np.pi, size=(n, 1))
    ang[:near_pi] = np.pi - np.logspace(-5, -1, near_pi)[:, None]
    return f32(axis * ang)


def _cams(n, seed=0):
    """Cameras on an arc looking at the origin region."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 0.6 * (i / max(n - 1, 1) - 0.5)
        rvec = np.array([0.3 + 0.05 * rng.normal(), a, 0.02 * rng.normal()])
        rot = np.asarray(jso3.exp(jnp.asarray(rvec)))
        center = np.array([10 * np.sin(a), -4.0, -10 * np.cos(a)])
        out.append(np.concatenate([rvec, -rot @ center]))
    return f32(np.stack(out))


@pytest.mark.parametrize("near_pi", [0, 8])
def test_so3_exp_log(near_pi):
    rv_np, rv_t = pair(_rvecs(1, 64, near_pi))
    rot_j = np.asarray(jso3.exp(jnp.asarray(rv_np)))
    rot_t = tso3.exp(rv_t).numpy()
    np.testing.assert_allclose(rot_t, rot_j, atol=1e-5)
    log_j = np.asarray(jso3.log(jnp.asarray(rot_j)))
    log_t = tso3.log(tt(rot_j)).numpy()
    np.testing.assert_allclose(log_t, log_j, atol=2e-4)
    # Round trip through the port alone (the pi band is where the skew
    # formula would amplify float32 noise).
    np.testing.assert_allclose(tso3.exp(tso3.log(tt(rot_t))).numpy(), rot_t, atol=2e-5)


def test_so3_log_identity_and_half_turn():
    rots = f32(np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0])]))
    np.testing.assert_allclose(
        tso3.log(tt(rots)).numpy(), np.asarray(jso3.log(jnp.asarray(rots))), atol=1e-6
    )


def test_projection_and_packing():
    pts_np, pts_t = pair(seeded_normal(2, (50, 3), 2.0))
    cams = _cams(6)
    proj_j = np.asarray(jproj.project_points(jnp.asarray(pts_np)[:, None], jnp.asarray(cams)[None], jnp.asarray(K)))
    proj_t = tproj.project_points(pts_t[:, None], tt(cams)[None], tt(K)).numpy()
    np.testing.assert_allclose(proj_t, proj_j, atol=1e-3)
    ext_j = np.asarray(jproj.extrinsics_from_params(jnp.asarray(cams), homogeneous=True))
    ext_t = tproj.extrinsics_from_params(tt(cams), homogeneous=True).numpy()
    np.testing.assert_allclose(ext_t, ext_j, atol=1e-5)
    np.testing.assert_allclose(
        tproj.params_from_extrinsics(tt(ext_j)).numpy(),
        np.asarray(jproj.params_from_extrinsics(jnp.asarray(ext_j))), atol=1e-4,
    )
    np.testing.assert_allclose(
        tproj.projection_from_extrinsic(tt(K), tt(ext_j)).numpy(),
        np.asarray(jproj.projection_from_extrinsic(jnp.asarray(K), jnp.asarray(ext_j))), rtol=1e-5,
    )


def test_distortion_round_trip():
    dist = f32([-0.12, 0.05, 0.001, -0.0015, 0.0])
    pix_np, pix_t = pair(np.random.default_rng(3).uniform([20, 20], [620, 460], size=(200, 2)))
    d_j = np.asarray(jdist.distort_pixels(jnp.asarray(pix_np), jnp.asarray(K), jnp.asarray(dist)))
    d_t = tdist.distort_pixels(pix_t, tt(K), tt(dist))
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=1e-3)
    u_j = np.asarray(jdist.undistort_pixels(jnp.asarray(d_j), jnp.asarray(K), jnp.asarray(dist)))
    u_t = tdist.undistort_pixels(d_t, tt(K), tt(dist)).numpy()
    np.testing.assert_allclose(u_t, u_j, atol=1e-3)
    np.testing.assert_allclose(u_t, pix_np, atol=1e-2)


def test_homography():
    src = f32(np.mgrid[0:4, 0:3].T.reshape(-1, 2) * 2.0)
    h_true = np.array([[40.0, 3.0, 200.0], [-2.0, 35.0, 150.0], [0.001, 0.002, 1.0]])
    hom = np.c_[src, np.ones(len(src))] @ h_true.T
    dst = f32(hom[:, :2] / hom[:, 2:] + np.random.default_rng(4).normal(scale=0.2, size=(len(src), 2)))
    h_j = np.asarray(jhom.find_homography(jnp.asarray(src), jnp.asarray(dst)))
    h_t = thom.find_homography(tt(src), tt(dst)).numpy()
    np.testing.assert_allclose(h_t, h_j, rtol=1e-3, atol=1e-5)


def _tri_problem():
    cams = _cams(5, seed=5)
    pts = seeded_normal(6, (40, 3), 1.5)
    proj_mats = np.asarray(jproj.projection_from_extrinsic(
        jnp.asarray(K), jproj.extrinsics_from_params(jnp.asarray(cams))))
    coords = np.asarray(jproj.project_points(jnp.asarray(pts)[:, None], jnp.asarray(cams)[None], jnp.asarray(K)))
    coords = f32(coords + np.random.default_rng(7).normal(scale=0.3, size=coords.shape))
    mask = np.random.default_rng(8).random((40, 5)) < 0.7
    mask[:, :2] = True
    return f32(proj_mats), coords, mask, pts


def test_triangulate_nview():
    proj_mats, coords, mask, pts = _tri_problem()
    x_j = np.asarray(jtri.triangulate_nview(jnp.asarray(proj_mats), jnp.asarray(coords), jnp.asarray(mask)))
    x_t = ttri.triangulate_nview(tt(proj_mats), tt(coords), tt(mask)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-3)
    assert np.abs(x_t - pts).max() < 0.5


def test_triangulate_pairs():
    proj_mats, coords, _, _ = _tri_problem()
    args_np = (proj_mats[0], proj_mats[3], coords[:, 0], coords[:, 3])
    x_j = np.asarray(jtri.triangulate_pairs(*(jnp.asarray(a) for a in args_np)))
    x_t = ttri.triangulate_pairs(*(tt(np.ascontiguousarray(a)) for a in args_np)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-3)


def _board_views(n_views, seed, noise=0.1):
    """(4, 3) X-Z board seen from tilted cameras, and the z=0 object points."""
    rng = np.random.default_rng(seed)
    obj = np.asarray(jcal.chessboard_object_points((4, 3)))
    views = []
    for i in range(n_views):
        rvec = np.array([0.4 * rng.normal(), 0.4 * rng.normal(), 0.2 * rng.normal()])
        tvec = np.array([-3.0 + rng.normal(), -2.0 + rng.normal(), 12.0 + 2 * rng.normal()])
        p = np.asarray(jproj.project_points(jnp.asarray(obj), jnp.asarray(np.r_[rvec, tvec])[None], jnp.asarray(K)))
        views.append(p + rng.normal(scale=noise, size=p.shape))
    return f32(obj), f32(np.stack(views))


@pytest.mark.parametrize("obj_cols", [(0, 1), (0, 2)])
def test_solve_pnp_batch(obj_cols):
    obj, views = _board_views(6, seed=9)
    a, b = obj_cols
    obj3 = np.zeros_like(obj)
    obj3[:, a], obj3[:, b] = obj[:, 0], obj[:, 1]
    plane = f32(obj[:, :2])
    if obj_cols == (0, 2):
        # Same pixels, board in the X-Z plane: re-project through X-Z poses.
        views = f32(np.asarray(jproj.project_points(
            jnp.asarray(obj3), jnp.asarray(_cams(6, seed=10))[:, None], jnp.asarray(K))))
    p_j = np.asarray(jpnp.solve_pnp_batch(jnp.asarray(plane), obj_cols, jnp.asarray(obj3), jnp.asarray(views), jnp.asarray(K)))
    p_t = tpnp.solve_pnp_batch(
        tt(plane), obj_cols, tt(obj3), tt(views), tt(K)
    ).numpy()
    np.testing.assert_allclose(p_t, p_j, atol=2e-3)
    reproj = tproj.project_points(tt(obj3)[None], tt(p_t)[:, None], tt(K)).numpy()
    assert np.abs(reproj - views).max() < 1.0


def test_chessboard_object_points():
    np.testing.assert_array_equal(
        tcal.chessboard_object_points((4, 3)).numpy(), np.asarray(jcal.chessboard_object_points((4, 3)))
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(num_dist=0, fix_principal_point=True, single_focal=True),
        dict(num_dist=2, fix_principal_point=False, single_focal=False),
    ],
)
def test_calibrate(kwargs):
    obj, views = _board_views(12, seed=11, noise=0.05)
    res_j = jcal.calibrate(jnp.asarray(views), jnp.asarray(obj), jnp.asarray(f32([640, 480])), **kwargs)
    res_t = tcal.calibrate(tt(views), tt(obj), (640, 480), **kwargs)
    k_j, k_t = np.asarray(res_j.intrinsics), res_t.intrinsics.numpy()
    # Focal to 1e-4 relative; the free principal point of the 4x3 board is
    # weakly constrained, so it is held to 1e-3 of the focal instead.
    np.testing.assert_allclose(k_t[0, 0], k_j[0, 0], rtol=1e-4)
    np.testing.assert_allclose(k_t[1, 1], k_j[1, 1], rtol=1e-4)
    np.testing.assert_allclose(k_t[:2, 2], k_j[:2, 2], atol=1e-3 * k_j[0, 0])
    np.testing.assert_allclose(float(res_t.rms), float(res_j.rms), rtol=1e-3, atol=1e-4)


def test_calibrate_view_mask_ignores_padding():
    obj, views = _board_views(10, seed=12, noise=0.05)
    padded = np.concatenate([views, np.repeat(views[:1], 6, 0)])
    mask = np.arange(16) < 10
    kw = dict(num_dist=0, fix_principal_point=True, single_focal=True)
    ref = tcal.calibrate(tt(views), tt(obj), (640, 480), **kw)
    got = tcal.calibrate(tt(padded), tt(obj), (640, 480),
                         view_mask=tt(mask), **kw)
    np.testing.assert_allclose(got.intrinsics.numpy(), ref.intrinsics.numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(got.rms), float(ref.rms), rtol=1e-3)
