"""The port's last public helpers against their JAX counterparts:
``volume.carved_volume`` (within 1% relative, the volume tests' bound),
``tracks.to_ba_arrays`` / ``Track`` / ``views_from_store`` and the package's
``Track`` export (exact), ``io.synthetic.degrade_sequence`` (exact: the same
numpy draws; ``jpeg`` raises naming cv2), ``utils.numerics.checked`` (raises
where JAX's checkify raises, naming the operation; a finite run is
unchanged), ``utils.profiling.trace`` / ``device_barrier``, and
``so3.exp_log_consistent`` (within 1e-6)."""

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
