"""The port's SoA track store against the JAX package: identical match
arrays must give exactly the same store, including masked match rows,
repeated query indices and a store that runs out of free slots."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu import tracks as jtracks
from meatmodeler_tpu_torch import tracks as ttracks
from meatmodeler_tpu_torch.testing import tt

torch.set_num_threads(2)


def _scenario(seed, n_kf=6, k=40, m=24, repeat_queries=True):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, size=(n_kf, k, 2)).astype(np.float32)
    octave = rng.integers(0, 3, size=(n_kf, k)).astype(np.int32)
    q = np.stack([rng.permutation(k)[:m] for _ in range(n_kf - 1)]).astype(np.int32)
    t = np.stack([rng.permutation(k)[:m] for _ in range(n_kf - 1)]).astype(np.int32)
    # Chain some matches so tracks extend across keyframes.
    q[1:, :8] = t[:-1, :8]
    if repeat_queries:
        q[:, 10] = q[:, 11]  # two match rows claim one feature
        q[:, 20] = q[:, 0]  # ... including a chained one
    mask = rng.random((n_kf - 1, m)) < 0.8
    mask[:, 20] = True
    return xy, octave, q, t, mask


def _run_both(capacity, n_kf, xy, octave, q, t, mask):
    js = jtracks.update_tracks_scan(
        jtracks.make_store(capacity, n_kf), jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
        jnp.asarray(xy), jnp.asarray(octave),
    )
    js = jtracks.finalize_tracks(js)
    ts = ttracks.update_tracks_scan(ttracks.make_store(capacity, n_kf), tt(q), tt(t), tt(mask), tt(xy), tt(octave))
    return js, ttracks.finalize_tracks(ts)


def _assert_same_store(js, ts):
    for name in ("coords", "obs_mask", "alive", "used", "last_feature_idx", "points", "octaves"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("seed,repeat", [(0, False), (1, True), (2, True)])
def test_update_tracks_scan_matches_jax(seed, repeat):
    xy, octave, q, t, mask = _scenario(seed, repeat_queries=repeat)
    js, ts = _run_both(256, xy.shape[0], xy, octave, q, t, mask)
    assert int(np.asarray(js.used).sum()) > 20
    _assert_same_store(js, ts)


def test_update_tracks_scan_capacity_exhausted():
    xy, octave, q, t, mask = _scenario(3)
    js, ts = _run_both(30, xy.shape[0], xy, octave, q, t, mask)
    assert bool(np.asarray(js.used).all())
    _assert_same_store(js, ts)


def test_triangulation_endpoints_match():
    xy, octave, q, t, mask = _scenario(4)
    js, ts = _run_both(256, xy.shape[0], xy, octave, q, t, mask)
    for a, b in zip(ttracks.triangulation_endpoints(ts), jtracks.triangulation_endpoints(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
