"""The port's volume estimators against the JAX package on an identical
cloud and identical projections: split masks within 1% of the points,
hull and carved volumes within 1% relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu import volume as jvol
from meatmodeler_tpu.geometry import projection as jproj
from meatmodeler_tpu_torch import volume as tvol
from meatmodeler_tpu_torch.testing import f32, tt

torch.set_num_threads(2)

K = f32([[420.0, 0, 200], [0, 420.0, 150], [0, 0, 1]])


@pytest.fixture(scope="module")
def cloud():
    """An ellipsoid surface floating above the y = 0 board plane, board
    points, and a few far outliers; cameras on a turntable arc."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(900, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    item = u * [2.0, 1.5, 1.8] + [11.5, -1.8, 2.0]
    item = item[item[:, 2] < 3.0]  # the seen side only
    board = np.c_[rng.uniform(0, 6, 150), np.zeros(150), rng.uniform(0, 4, 150)]
    outliers = rng.uniform([0, -12, -5], [20, -3, 10], size=(12, 3))
    pts = f32(np.concatenate([item, board, outliers]) + rng.normal(scale=0.02, size=(len(item) + 162, 3)))
    cams = []
    for i in range(8):
        a = np.deg2rad(50) * (i / 7 - 0.5)
        target = np.array([7.25, -0.9, 3.0])
        center = target + [18 * np.sin(a), -8.5, -18 * np.cos(a)]
        fwd = (target - center) / np.linalg.norm(target - center)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd])
        cams.append(np.c_[rot, -rot @ center])
    ext = f32(np.stack(cams))
    proj = f32(np.asarray(jproj.projection_from_extrinsic(jnp.asarray(K), jnp.asarray(ext))))
    return pts, proj


@pytest.mark.parametrize("use_plane", [True, False])
def test_split_item_points(cloud, use_plane):
    pts, _ = cloud
    mask = np.ones(len(pts), bool)
    mask[::17] = False
    j = np.asarray(jvol.split_item_points(jnp.asarray(pts), jnp.asarray(mask), use_plane=use_plane))
    t = tvol.split_item_points(tt(pts), tt(mask), use_plane=use_plane).numpy()
    assert j.sum() > 100
    assert (j != t).sum() <= 0.01 * len(pts)


@pytest.mark.parametrize("trim_ref", [0, 1500])
def test_hull_and_carved_volume(cloud, trim_ref):
    pts, proj = cloud
    item = np.asarray(jvol.split_item_points(jnp.asarray(pts), jnp.asarray(np.ones(len(pts), bool))))
    pmask = np.ones(len(proj), bool)
    pmask[3] = False
    kw = dict(image_size=(400, 300), resolution=40, num_directions=256, trim=5, dilation=5,
              grid_step=4, close_frac=0.029, vote_frac=0.8, trim_ref=trim_ref)
    jh, jc = jvol.hull_and_carved_volume(jnp.asarray(pts), jnp.asarray(item), jnp.asarray(proj), jnp.asarray(pmask), **kw)
    th, tc = tvol.hull_and_carved_volume(tt(pts), tt(item), tt(proj), tt(pmask), **kw)
    assert float(jh) > 1.0
    np.testing.assert_allclose(float(th), float(jh), rtol=0.01)
    np.testing.assert_allclose(float(tc), float(jc), rtol=0.01)


def test_convex_hull_volume(cloud):
    pts, _ = cloud
    mask = np.asarray(jvol.split_item_points(jnp.asarray(pts), jnp.asarray(np.ones(len(pts), bool))))
    j = float(jvol.convex_hull_volume(jnp.asarray(pts), jnp.asarray(mask), resolution=40, num_directions=128))
    t = float(tvol.convex_hull_volume(tt(pts), tt(mask), resolution=40, num_directions=128))
    np.testing.assert_allclose(t, j, rtol=0.01)


@pytest.mark.parametrize("r", [1, 3])
def test_separable_morphology_matches(r):
    g = (np.random.default_rng(5).random((2, 30, 40)) < 0.1).astype(np.float32)
    for jf, tf in ((jvol.maxpool_sep, tvol.maxpool_sep), (jvol.erode_sep, tvol.erode_sep)):
        ref = np.stack([np.asarray(jf(jnp.asarray(x), r)) for x in g])
        np.testing.assert_array_equal(tf(tt(g), r).numpy(), ref)
