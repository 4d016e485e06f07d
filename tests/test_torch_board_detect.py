"""The port's device chessboard detector and its pipeline glue against the
JAX package, on the same rendered frames (640x480, (4, 3) pattern).

Tolerances: ``saddle_response`` 1e-4 relative to its peak; the saddle
candidates an identical set (positions 1e-3 px); detections the same
``ok`` and corners within 1e-3 px after ``canonicalize_corners`` and the
180-degree flip (orderings of one board score equal objectives up to
summation order, so the winning traversal may differ); the planar-fit
residual 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu import pipeline as jpipe
from meatmodeler_tpu.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu.ops import board_detect as jbd
from meatmodeler_tpu.ops import chessboard as jcb
from meatmodeler_tpu_torch import pipeline as tpipe
from meatmodeler_tpu_torch.ops import board_detect as tbd
from meatmodeler_tpu_torch.ops import chessboard as tcb
from meatmodeler_tpu_torch.testing import from_fields, pair

torch.set_num_threads(2)

PATTERN = (4, 3)


def _grey(frame):
    return (frame[..., 0] * 0.114 + frame[..., 1] * 0.587 + frame[..., 2] * 0.299).astype(np.float32)


@pytest.fixture(scope="module")
def rendered():
    frames, _, corners = render_sequence(TurntableScene(), 5, seed=1)
    return frames, corners


def _images(rendered):
    frames, _ = rendered
    noise = np.random.default_rng(0).normal(128.0, 12.0, size=(240, 320)).astype(np.float32)
    return {
        "board": _grey(frames[1]),
        "board_half": np.ascontiguousarray(_grey(frames[3])[::2, ::2]),
        "noise": noise,
        "structure": np.ascontiguousarray(_grey(frames[0])[:, 416:]),
    }


def _same_board(got, ref):
    cg = tcb.canonicalize_corners(got, PATTERN)
    cr = jcb.canonicalize_corners(ref, PATTERN)
    return min(np.abs(cg - cr).max(), np.abs(cg[::-1] - cr).max())


def test_saddle_response(rendered):
    img, img_t = pair(_images(rendered)["board"])
    ref = np.asarray(jbd.saddle_response(jnp.asarray(img)))
    got = tbd.saddle_response(img_t[None])[0].numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("which", ["board", "board_half", "structure"])
def test_saddle_candidates_same_set(rendered, which):
    img, img_t = pair(_images(rendered)[which])
    ref = jbd.saddle_candidates(jnp.asarray(img), max_candidates=24)
    got = tbd.saddle_candidates(img_t[None], max_candidates=24)
    mask_j, mask_t = np.asarray(ref.mask), got.mask[0].numpy()
    assert mask_t.sum() == mask_j.sum()
    xy_j = np.asarray(ref.xy)[mask_j]
    xy_t = got.xy[0].numpy()[mask_t]
    d = np.linalg.norm(xy_t[:, None] - xy_j[None], axis=-1)
    assert d.min(axis=1).max() <= 1e-3 and d.min(axis=0).max() <= 1e-3


@pytest.mark.parametrize("which", ["board", "board_half", "noise", "structure"])
def test_find_chessboard_device(rendered, which):
    img, img_t = pair(_images(rendered)[which])
    ref = jbd.find_chessboard_device(jnp.asarray(img), pattern=PATTERN)
    got = tbd.find_chessboard_device(img_t, pattern=PATTERN)
    assert bool(got.ok) == bool(ref.ok)
    assert bool(got.ok) == which.startswith("board")
    if bool(ref.ok):
        assert _same_board(got.corners.numpy(), np.asarray(ref.corners)) <= 1e-3
        np.testing.assert_allclose(float(got.residual), float(ref.residual), atol=1e-3)


def test_batched_detection_matches_single(rendered):
    imgs = _images(rendered)
    stack = torch.stack([pair(imgs[k])[1] for k in ("board", "board")])
    stack[1] = torch.from_numpy(np.ascontiguousarray(imgs["board"][::-1, ::-1]))
    got = tbd.find_chessboard_device(stack, pattern=PATTERN)
    one = tbd.find_chessboard_device(stack[0], pattern=PATTERN)
    assert got.ok.tolist() == [True, True]
    np.testing.assert_array_equal(got.corners[0].numpy(), one.corners.numpy())


def test_board_fit_residual(rendered):
    _, corners = rendered
    c = corners[2].astype(np.float32)
    bad = c.copy()
    bad[5] += np.float32([4.0, -3.0])
    for pts in (c, bad):
        ref = jpipe._board_fit_residual(pts, PATTERN)
        np.testing.assert_allclose(tpipe._board_fit_residual(pts, PATTERN), ref, rtol=1e-6, atol=1e-9)
    assert tpipe._board_fit_residual(c, PATTERN) < 0.05 < 3.0 < tpipe._board_fit_residual(bad, PATTERN)


def test_detect_board_device_batch_glue(rendered):
    """The batched detector + planar gate of the pipeline, at pass-1 scale 2:
    full-resolution, canonicalized corners or None, as the reference's."""
    frames, corners_gt = rendered
    greys = np.stack([_grey(f)[::2, ::2] for f in frames[:3]] + [_images(rendered)["noise"][:240, :320]])
    greys_np, greys_t = pair(greys)
    cfg = jpipe.DEFAULT_CONFIG.chessboard
    ref = jpipe._detect_board_device_batch([jnp.asarray(g) for g in greys_np], PATTERN, 2, cfg)
    got = tpipe._detect_board_device_batch(greys_t, PATTERN, 2, from_fields(cfg))
    assert [c is None for c in got] == [c is None for c in ref] == [False, False, False, True]
    for g, r, gt in zip(got[:3], ref[:3], corners_gt[:3]):
        assert _same_board(g, r) <= 2e-3
        assert np.linalg.norm(g[:, None] - gt[None], axis=-1).min(axis=1).max() < 3.0

