"""Colour conversion, the ``bgr_lab`` enhance, Shi-Tomasi corners, LK and
the device keyframe scan of the port against the JAX package, on the same
seeded float32 / uint8 inputs.

Tolerances (0..255 intensity scale):
  * ``bgr_to_lab`` 1e-4 and ``lab_to_bgr`` 2e-3 absolute. Under the suite's
    x64 mode the JAX functions compute in float64 (their colour matrices
    are float64 constants); the port computes in float32 and takes the cube
    root as ``t ** (1/3)``.
  * ``enhanced_grey`` 1e-3 absolute on at least 99.99% of pixels and 8
    grey levels on every pixel: a lightness within ~1e-5 of an x.5 can
    round into the neighbouring CLAHE bin and take that bin's LUT value (no
    such pixel occurs on these inputs; measured max 3.7e-4).
  * ``good_features``: identical corners and mask. Pyramids 1e-4; LK points
    1e-3 px with identical status; the scan's keyframe flags identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu.io import native_ops
from meatmodeler_tpu.io.synthetic import render_sequence
from meatmodeler_tpu.ops import clahe as jclahe
from meatmodeler_tpu.ops import color as jcolor
from meatmodeler_tpu.ops import features as jfeat
from meatmodeler_tpu.ops import klt as jklt
from meatmodeler_tpu.pipeline import _make_keyframe_scan as jax_keyframe_scan
from meatmodeler_tpu_torch.ops import clahe as tclahe
from meatmodeler_tpu_torch.ops import color as tcolor
from meatmodeler_tpu_torch.ops import features as tfeat
from meatmodeler_tpu_torch.ops import klt as tklt
from meatmodeler_tpu_torch.pipeline import _make_keyframe_scan as torch_keyframe_scan
from meatmodeler_tpu_torch.testing import from_fields, pair, tt
from test_pipeline import SCENE, TEST_CONFIG

torch.set_num_threads(2)


def _bgr(seed, shape=(2, 96, 128, 3)):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.uint8)


def _blobs(dx=0.0, dy=0.0, h=240, w=320, seed=3):
    """Blobby texture whose blob centres move by (dx, dy): an exact
    sub-pixel shift with no resampling."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(60):
        cy, cx = rng.uniform(20, h - 20), rng.uniform(20, w - 20)
        sy, sx = rng.uniform(2, 6), rng.uniform(2, 6)
        amp = rng.uniform(60, 200)
        img += amp * np.exp(-(((yy - cy - dy) / sy) ** 2 + ((xx - cx - dx) / sx) ** 2))
    return np.clip(img, 0, 255).astype(np.float32)


def test_bgr_to_lab_and_back():
    bgr = _bgr(0)
    lab_j = np.asarray(jcolor.bgr_to_lab(jnp.asarray(bgr)))
    lab_t = tcolor.bgr_to_lab(torch.from_numpy(bgr)).numpy()
    np.testing.assert_allclose(lab_t, lab_j, atol=1e-4)
    lab, lab_tt = pair(lab_j)
    back_j = np.asarray(jcolor.lab_to_bgr(jnp.asarray(lab)))
    np.testing.assert_allclose(tcolor.lab_to_bgr(lab_tt).numpy(), back_j, atol=2e-3)
    np.testing.assert_allclose(
        tcolor.bgr_to_grey(torch.from_numpy(bgr)).numpy(), np.asarray(jcolor.bgr_to_grey(jnp.asarray(bgr))), atol=1e-4
    )


@pytest.mark.parametrize("source", ["noise", "scene"])
def test_enhanced_grey(source):
    if source == "noise":
        bgr = _bgr(1)
    else:
        bgr = render_sequence(SCENE, 3, seed=0)[0]
    ref = np.asarray(jclahe.enhanced_grey(jnp.asarray(bgr)))
    got = tclahe.enhanced_grey(torch.from_numpy(bgr)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    diff = np.abs(got - ref)
    assert np.mean(diff <= 1e-3) >= 0.9999, np.mean(diff <= 1e-3)
    assert diff.max() <= 8.0


@pytest.mark.parametrize("max_corners,min_distance", [(100, 7), (256, 10)])
def test_good_features_identical(max_corners, min_distance):
    img, img_t = pair(_blobs(seed=max_corners))
    ref = jfeat.good_features(img, max_corners=max_corners, min_distance=min_distance)
    got = tfeat.good_features(img_t, max_corners=max_corners, min_distance=min_distance)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_allclose(got.response.numpy(), np.asarray(ref.response), rtol=1e-4, atol=1e-12)
    # A batch gives each image's own result.
    both = tfeat.good_features(torch.stack([img_t, img_t.flip(0)]), max_corners=max_corners, min_distance=min_distance)
    np.testing.assert_array_equal(both.xy[0].numpy(), got.xy.numpy())


def test_min_eig_response():
    img, img_t = pair(_blobs(seed=5))
    ref = np.asarray(jfeat.min_eig_response(jnp.asarray(img)))
    got = tfeat.min_eig_response(img_t[None])[0].numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_pyramid_and_lucas_kanade():
    a, b = _blobs(), _blobs(dx=3.4, dy=-2.2)
    pj1, pj2 = tuple(jklt.build_pyramid(jnp.asarray(a), 4)), tuple(jklt.build_pyramid(jnp.asarray(b), 4))
    pt1, pt2 = tklt.build_pyramid(tt(a), 4), tklt.build_pyramid(tt(b), 4)
    for lj, lt in zip(pj1, pt1):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    c = jfeat.good_features(a, max_corners=64)
    pts, pts_t = pair(np.asarray(c.xy))
    mask = np.array(c.mask)
    mask[::9] = False  # some padding entries
    ref = jklt.lucas_kanade(pj1, pj2, jnp.asarray(pts), win=21, levels=4, max_iters=30, point_mask=jnp.asarray(mask))
    got = tklt.lucas_kanade(pt1, pt2, pts_t, win=21, levels=4, max_iters=30, point_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=1e-3)
    err_j, err_t = np.asarray(ref.error), got.error.numpy()
    np.testing.assert_array_equal(np.isnan(err_t), np.isnan(err_j))
    np.testing.assert_allclose(err_t[~np.isnan(err_t)], err_j[~np.isnan(err_j)], atol=1e-3)
    # The shift itself is recovered.
    flow = (got.points.numpy() - pts)[got.status.numpy()]
    np.testing.assert_allclose(flow.mean(axis=0), [3.4, -2.2], atol=0.05)


def test_keyframe_scan_flags_identical():
    """The 40-frame test clip through both scans in chunks of 8, bootstrapped
    at frame 0 as the known-corner path does: identical flags."""
    frames = render_sequence(SCENE, 40, seed=0)[0]
    greys = tclahe.clahe_reference(torch.from_numpy(native_ops.bgr_to_grey_down(frames, 1)).to(torch.float32))
    greys_np, greys_t = pair(greys.numpy())
    j_init, j_scan = jax_keyframe_scan(TEST_CONFIG)
    t_init, t_scan = torch_keyframe_scan(from_fields(TEST_CONFIG))
    j_carry, t_carry = j_init(jnp.asarray(greys_np[0])), t_init(greys_t[0])
    flags_j, flags_t = [], []
    for i in range(0, 40, 8):
        j_carry, fj = j_scan(j_carry, jnp.asarray(greys_np[i : i + 8]), width_scale=1)
        t_carry, ft = t_scan(t_carry, greys_t[i : i + 8], width_scale=1)
        flags_j.append(np.asarray(fj))
        flags_t.append(ft.numpy())
    flags_j, flags_t = np.concatenate(flags_j), np.concatenate(flags_t)
    assert flags_j.sum() >= 3
    np.testing.assert_array_equal(flags_t, flags_j)
    np.testing.assert_allclose(float(t_carry[3]), float(j_carry[3]), rtol=1e-3, atol=1e-3)


def test_good_features_is_exact_topk():
    """The scan's reseed: ties in the response rank the lower pixel index
    first, as lax.top_k (exact on the CPU) does."""
    img = np.zeros((64, 64), np.float32)
    img[20:40, 20:40] = 200.0  # a square: four equal corners
    ref = jfeat.good_features(img, max_corners=8)
    got = tfeat.good_features(torch.from_numpy(img), max_corners=8)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
