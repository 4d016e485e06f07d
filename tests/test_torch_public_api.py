"""The port's last public helpers against their JAX counterparts:
``volume.carved_volume`` (within 1% relative, the volume tests' bound),
``tracks.to_ba_arrays`` / ``Track`` / ``views_from_store`` and the package's
``Track`` export (exact), ``io.synthetic.degrade_sequence`` (exact: the same
numpy draws; ``jpeg`` raises naming cv2), ``utils.numerics.checked`` (raises
where JAX's checkify raises, naming the operation; a finite run is
unchanged), ``utils.profiling.trace`` / ``device_barrier``, and
``so3.exp_log_consistent`` (within 1e-6). Then the reference's call forms:
the single-image (H, W) functions against JAX on one image (within 1e-4
relative to the output's scale; candidates and corners within 1e-3 px),
``process``'s positional cv2 parameter dicts (the same ``config.keyframe``
as JAX folds them into), and the keywords the port accepts and ignores
(``exact_topk``, ``bin_weights``, ``topk_recall``: the same outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meatmodeler_tpu
import meatmodeler_tpu_torch
from meatmodeler_tpu import tracks as jtracks
from meatmodeler_tpu import volume as jvol
from meatmodeler_tpu.geometry import so3 as jso3
from meatmodeler_tpu.io import synthetic as jsynth
from meatmodeler_tpu.utils import numerics as jnumerics
from meatmodeler_tpu_torch import tracks as ttracks
from meatmodeler_tpu_torch import volume as tvol
from meatmodeler_tpu_torch.geometry import so3 as tso3
from meatmodeler_tpu_torch.io import synthetic as tsynth
from meatmodeler_tpu_torch.testing import f32, tt
from meatmodeler_tpu_torch.utils import numerics as tnumerics
from meatmodeler_tpu_torch.utils import profiling as tprofiling
from test_torch_volume import cloud  # noqa: F401  (a fixture)

torch.set_num_threads(2)


@pytest.mark.parametrize("resolution,dilation", [(32, 9), (48, 13)])
def test_carved_volume(cloud, resolution, dilation):  # noqa: F811
    pts, proj = cloud
    mask = np.ones(len(pts), bool)
    mask[::11] = False
    proj_mask = np.array([True] * 7 + [False])
    j = float(jvol.carved_volume(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(proj), jnp.asarray(proj_mask), (400, 300),
        resolution=resolution, dilation=dilation,
    ))
    t = tvol.carved_volume(tt(pts), tt(mask), tt(proj), tt(proj_mask), (400, 300), resolution=resolution, dilation=dilation)
    assert t.ndim == 0 and j > 0
    np.testing.assert_allclose(float(t), j, rtol=1e-2)


def _stores(seed=0, t=64, f=6):
    """The same random store in both packages: some used tracks with one,
    two or more observations."""
    rng = np.random.default_rng(seed)
    coords = f32(rng.uniform(0, 300, size=(t, f, 2)))
    obs_mask = rng.random((t, f)) < 0.4
    used = rng.random(t) < 0.8
    points = f32(rng.normal(size=(t, 3)))
    octaves = rng.integers(0, 3, size=(t, f)).astype(np.int32)
    alive = np.zeros(t, bool)
    last = np.full(t, -1, np.int32)
    js = jtracks.TrackStore(*(jnp.asarray(a) for a in (coords, obs_mask, alive, used, last, points, octaves)))
    ts = ttracks.TrackStore(*(tt(a) for a in (coords, obs_mask, alive, used, last.astype(np.int64), points, octaves)))
    return js, ts


def test_to_ba_arrays():
    js, ts = _stores()
    ref = jtracks.to_ba_arrays(js)
    got = ttracks.to_ba_arrays(ts)
    assert len(ref[0]) > 10
    for r, g in zip(ref, got):
        assert isinstance(g, np.ndarray) and g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_views_from_store_and_track():
    js, ts = _stores(seed=1)
    ref = jtracks.views_from_store(js)
    got = ttracks.views_from_store(ts)
    assert len(got) == len(ref) > 10
    for r, g in zip(ref, got):
        assert type(g) is ttracks.Track
        assert g.getCoordinates() == r.getCoordinates()
        assert g.getTriangulationData() == r.getTriangulationData()
        assert g.wasUpdated() == r.wasUpdated()
        np.testing.assert_array_equal(g.getPoint(), r.getPoint())
    assert meatmodeler_tpu_torch.Track is ttracks.Track
    jt, tr = meatmodeler_tpu.Track(0, (1.0, 2.0), 1, (3.0, 4.0)), meatmodeler_tpu_torch.Track(0, (1.0, 2.0), 1, (3.0, 4.0))
    for track in (jt, tr):
        track.update(3, (5.0, 6.0))
        track.setPoint(np.ones((1, 3)))
    assert tr.getCoordinates() == jt.getCoordinates() and tr.wasUpdated() == jt.wasUpdated()
    assert tr.getCoordinate(3) == jt.getCoordinate(3) and tr.getTriangulationData() == jt.getTriangulationData()
    tr.reset()
    assert not tr.wasUpdated()


@pytest.mark.parametrize("kind,strength", [("noise", 1.0), ("blur", 1.0), ("blur", 0.3), ("flicker", 1.5), ("occlusion", 1.0)])
def test_degrade_sequence(kind, strength):
    frames = np.random.default_rng(4).integers(0, 256, size=(7, 48, 64, 3)).astype(np.uint8)
    ref = jsynth.degrade_sequence(frames, kind, seed=5, strength=strength)
    got = tsynth.degrade_sequence(frames, kind, seed=5, strength=strength)
    assert got.dtype == np.uint8 and got.shape == frames.shape
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, frames)


def test_degrade_sequence_refusals():
    frames = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="cv2"):
        tsynth.degrade_sequence(frames, "jpeg")
    with pytest.raises(ValueError, match="unknown degradation"):
        tsynth.degrade_sequence(frames, "fog")


def _ratio(lib, x):
    return lib.log(x) / x.sum()


def test_checked():
    good = f32([1.0, 2.0, 3.0])
    bad = f32([1.0, -2.0, 3.0])  # log(-2) is NaN
    np.testing.assert_allclose(
        tnumerics.checked(lambda x: _ratio(torch, x))(tt(good)).numpy(),
        np.asarray(jnumerics.checked(lambda x: _ratio(jnp, x))(jnp.asarray(good))), rtol=1e-6,
    )
    with pytest.raises(Exception, match="nan"):
        jnumerics.checked(lambda x: _ratio(jnp, x))(jnp.asarray(bad))
    with pytest.raises(tnumerics.NumericsError, match="log"):
        tnumerics.checked(lambda x: _ratio(torch, x))(tt(bad))
    # A division by zero, inside a returned tuple.
    with pytest.raises(tnumerics.NumericsError, match="div"):
        tnumerics.checked(lambda x: (x, x / 0.0))(tt(good))
    # Outside the wrapper nothing is checked.
    assert torch.isnan(_ratio(torch, tt(bad))).any()


def test_trace_and_device_barrier():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprofiling.trace("sharded-stage"):
            torch.ones(3).sum()
        metrics = tprofiling.Metrics()
        with metrics.stage("a-metrics-stage"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"sharded-stage", "a-metrics-stage"} <= names
    tprofiling.device_barrier()  # nothing queued on a CUDA device: returns


def test_exp_log_consistent():
    rng = np.random.default_rng(6)
    rvec = f32(np.concatenate([rng.normal(size=(64, 3)), [[0.0, 0.0, 0.0], [1e-8, 0.0, 0.0], [0.0, 3.1, 0.0]]]))
    ref = np.asarray(jso3.exp_log_consistent(jnp.asarray(rvec)))
    got = tso3.exp_log_consistent(tt(rvec)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _board_image(seed=0, shape=(72, 96)):
    """A seeded grey checkerboard (12-px squares) with noise, float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    img = np.where(((yy + 5) // 12 + (xx + 7) // 12) % 2 == 0, 200.0, 40.0)
    return f32(img + rng.normal(scale=4.0, size=shape))


def _single_image_calls():
    from meatmodeler_tpu.ops import board_detect as jbd
    from meatmodeler_tpu.ops import chessboard as jcb
    from meatmodeler_tpu.ops import features as jfeat
    from meatmodeler_tpu.ops import orb as jorb
    from meatmodeler_tpu_torch.ops import board_detect as tbd
    from meatmodeler_tpu_torch.ops import chessboard as tcb
    from meatmodeler_tpu_torch.ops import features as tfeat
    from meatmodeler_tpu_torch.ops import orb as torb

    corners = f32([[18.6, 16.8], [31.2, 17.4], [43.1, 29.2], [54.6, 41.3]])
    return {
        "sobel": (jfeat.sobel, tfeat.sobel, ()),
        "structure_tensor": (jfeat.structure_tensor, tfeat.structure_tensor, ()),
        "min_eig_response": (jfeat.min_eig_response, tfeat.min_eig_response, ()),
        "harris_response": (jfeat.harris_response, tfeat.harris_response, ()),
        "fast_score": (jorb.fast_score, torb.fast_score, ()),
        "saddle_response": (jbd.saddle_response, tbd.saddle_response, ()),
        "saddle_candidates": (jbd.saddle_candidates, tbd.saddle_candidates, ()),
        "refine_corners_subpix": (jcb.refine_corners_subpix, tcb.refine_corners_subpix, (corners,)),
    }


@pytest.mark.parametrize("name", list(_single_image_calls()))
def test_single_image_calls_match_jax(name):
    """Each of these takes one (H, W) image as the JAX package documents it
    (``refine_corners_subpix`` with (N, 2) corners) and returns the JAX
    shapes and values."""
    jfn, tfn, extra = _single_image_calls()[name]
    img = _board_image()
    ref = jfn(jnp.asarray(img), *(jnp.asarray(e) for e in extra))
    got = tfn(tt(img), *(tt(e) for e in extra))
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(gots) == len(refs)
    for g, r in zip(gots, refs):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        if r.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), r)
        elif name in ("saddle_candidates", "refine_corners_subpix"):
            np.testing.assert_allclose(g.numpy(), r, atol=1e-3, rtol=1e-4)
        else:
            np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * max(1.0, float(np.abs(r).max())), rtol=0)


def test_process_takes_reference_param_dicts(monkeypatch):
    """``process(video, path, lk_params, feature_params, flann_params,
    config, ...)`` positionally, as the JAX package's signature has it:
    the cv2 dicts reach the same ``config.keyframe`` as JAX's
    ``_config_from_param_dicts`` makes of them; ``flann_params`` is
    ignored; ``device`` stays a keyword."""
    from meatmodeler_tpu import pipeline as jpipe
    from meatmodeler_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
    from meatmodeler_tpu_torch import pipeline as tpipe
    from meatmodeler_tpu_torch.testing import from_fields

    lk = {"winSize": (17, 17), "maxLevel": 2, "criteria": (3, 25, 0.02)}
    feat = {"maxCorners": 77, "qualityLevel": 0.05, "minDistance": 9, "blockSize": 5}
    seen = {}

    class Stop(Exception):
        pass

    def capture(video, config, *args, **kwargs):
        seen["config"] = config
        raise Stop

    monkeypatch.setattr(tpipe, "_reconstruct_to_ba", capture)
    frames = np.zeros((2, 32, 32, 3), np.uint8)
    corners = np.zeros((2, 12, 2), np.float32)
    with pytest.raises(Stop):
        tpipe.process(frames, None, lk, feat, {"algorithm": 1}, tpipe.DEFAULT_CONFIG, corners, device="cpu")
    want = from_fields(jpipe._config_from_param_dicts(JAX_DEFAULT, lk, feat))
    assert seen["config"].keyframe == want.keyframe
    assert seen["config"] == want


def test_reference_keywords_are_accepted():
    """``exact_topk`` on ``good_features``, ``saddle_candidates`` and
    ``find_chessboard_device``, and ``bin_weights`` / ``topk_recall`` on
    ``detect_and_compute`` in the JAX positions: accepted, outputs
    unchanged."""
    from meatmodeler_tpu_torch.ops import board_detect as tbd
    from meatmodeler_tpu_torch.ops import features as tfeat
    from meatmodeler_tpu_torch.ops import orb as torb

    img = tt(_board_image(1, (96, 128)))

    def same(a, b):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)

    same(tfeat.good_features(img, 32, 0.01, 7, 7, True), tfeat.good_features(img, 32))
    same(tbd.saddle_candidates(img, 24, 7, 0.1, True), tbd.saddle_candidates(img))
    same(tbd.find_chessboard_device(img, (4, 3), 24, 8, 3.0, 7, True), tbd.find_chessboard_device(img, hyp_candidates=8))
    same(torb.detect_and_compute(img, 64, 1, 1.2, 20.0, None, 0.9), torb.detect_and_compute(img, 64, 1))
