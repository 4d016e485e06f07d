"""What ORB's card kernels (``csrc/orb.cu``) read from the host, and the
arithmetic they repeat, held to the plain path on the CPU: the packed
BRIEF table, the banded downscale taps at the cells' level sizes, the
blur's order, FAST's arc windows, and the dispatch that keeps CPU stacks on
the plain path. The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``), with no JAX there: they are held to
the JAX package through ``data/orb_jax_reference.npz``, two frames and the
JAX package's features of them, which the tests here keep true to the JAX
package and hold the plain path to as well."""

from pathlib import Path

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch.ops import orb
from meatmodeler_tpu_torch.tools import orb_bench
from meatmodeler_tpu_torch.utils.profiling import Metrics

JAX_REFERENCE = Path(__file__).parent / "data" / "orb_jax_reference.npz"
JAX_REFERENCE_KW = dict(max_features=512, num_levels=3)

# Level sizes (in, out) of each axis: the board cells' 540 x 960 keyframes
# (known, video and batch), two-view's 720 x 1280 image, and a stack at the
# _PATCH + 2 floor.
LEVEL_SIZES = [
    (540, 450), (450, 375), (375, 312), (960, 800), (800, 667), (667, 556),
    (720, 600), (600, 500), (500, 417), (1280, 1067), (1067, 889), (889, 741),
    (40, 33), (33, 33),
]


def _unpack(table):
    """The packed table back to (rows, cols, weights) as ``_brief_taps``."""
    t = table.view(np.uint32)
    y0, x0 = t[..., 0] & 0xFF, (t[..., 0] >> 8) & 0xFF
    rows = y0[..., None] + np.array([0, 0, 1, 1])
    cols = x0[..., None] + np.array([0, 1, 0, 1])
    bits = np.stack([t[..., 1] & 0xFFFF, t[..., 1] >> 16, t[..., 2] & 0xFFFF, t[..., 2] >> 16], -1)
    wts = (bits.astype(np.uint32) << 16).view(np.float32)
    return rows, cols, wts


def test_brief_table_unpacks_to_brief_taps():
    table = orb._brief_table()
    assert table.shape == (orb._NBINS, 512, 4) and table.dtype == np.int32
    assert not table[..., 3].any()
    rows, cols, wts = _unpack(table)
    ref_rows, ref_cols, ref_wts = (t.numpy() for t in orb._brief_taps())
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(cols, ref_cols)
    assert np.array_equal(wts.view(np.uint32), ref_wts.view(np.uint32))


@pytest.mark.parametrize("in_size,out_size", LEVEL_SIZES)
def test_resize_taps_rebuild_resize_weights(in_size, out_size):
    start, weights = orb._resize_taps(in_size, out_size)
    n = weights.shape[1]
    assert start.dtype == np.int32 and weights.dtype == np.float32 and n <= 8
    assert n <= 3 or in_size == out_size  # 1/1.2 touches at most 3 inputs
    assert start.min() >= 0 and start.max() + n <= in_size
    dense = np.zeros((in_size, out_size), np.float32)
    dense[start[None, :] + np.arange(n)[:, None], np.arange(out_size)[None, :]] = weights.T
    ref = orb._resize_weights(in_size, out_size)
    assert np.array_equal(dense.view(np.uint32), ref.view(np.uint32))


def test_next_sizes_of_the_cells():
    assert [orb._next_size(540, 960, 1.2), orb._next_size(450, 800, 1.2), orb._next_size(375, 667, 1.2)] == [
        (450, 800), (375, 667), (312, 556)]
    assert orb._next_size(40, 40, 1.2) == (33, 33) and orb._next_size(33, 33, 1.2) == (33, 33)


def test_gauss7_is_the_kernels_unfused_order():
    """``_gauss7`` bit for bit as the level kernel computes it: rows first at
    replicate-clamped coordinates, then columns, each tap a rounded product
    added in order."""
    img = np.random.default_rng(5).uniform(0, 255, (2, 37, 45)).astype(np.float32)
    g = orb._gauss_taps()
    h, w = img.shape[1:]
    ys = np.clip(np.arange(h)[:, None] + np.arange(-3, 4)[None, :], 0, h - 1)
    xs = np.clip(np.arange(w)[:, None] + np.arange(-3, 4)[None, :], 0, w - 1)
    tmp = g[0] * img[:, ys[:, 0], :]
    for k in range(1, 7):
        tmp = (tmp + (g[k] * img[:, ys[:, k], :]).astype(np.float32)).astype(np.float32)
    out = g[0] * tmp[:, :, xs[:, 0]]
    for k in range(1, 7):
        out = (out + (g[k] * tmp[:, :, xs[:, k]]).astype(np.float32)).astype(np.float32)
    assert np.array_equal(orb._gauss7(torch.from_numpy(img)).numpy(), out)


def test_fast_arc_windows_are_the_kernels():
    """The kernel's arc test, 9 set bits starting at ring position 0..14 of
    the ring and its first 7 positions, on every one of the 2^16 ring
    patterns, against ``fast_score`` (brighter, then darker)."""
    masks = np.arange(1 << 16, dtype=np.uint32)
    doubled = masks | (masks << 16)
    run = doubled.copy()
    for s in range(1, 9):
        run &= doubled >> s
    expect = (run & 0x7FFF) != 0
    for ring_value in (100.0, 0.0):
        img = np.full((1 << 16, 7, 7), 50.0, np.float32)
        for k, (dy, dx) in enumerate(orb._RING):
            img[:, 3 + dy, 3 + dx] = np.where((masks >> k) & 1, ring_value, 50.0)
        got = orb.fast_score(torch.from_numpy(img))[:, 3, 3].numpy() > 0
        np.testing.assert_array_equal(got, expect)


def test_cpu_stack_takes_the_plain_path_without_kernel_levels(monkeypatch):
    def card(*a, **k):
        raise AssertionError("a CPU stack reached the card path")

    monkeypatch.setattr(orb, "_detect_card", card)
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 64, 80)).astype(np.float32))
    metrics = Metrics()
    with metrics.stage("pass2_orb"):
        out = orb.detect_and_compute(img, max_features=200, num_levels=2)
    assert not any(k.startswith("orb_kernel_levels") for k in metrics.as_dict()["counters"])
    ref = orb._detect_plain(img, 200, 2, 1.2, 20.0, 0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out.descriptors.shape == (3, 200, 256) and bool(out.mask.any())


def jax_reference_frames() -> np.ndarray:
    """(2, 180, 240) uint16: CLAHE'd turntable greys (frames 0 and 2, seed
    0) in steps of 1/256, so the float32 frames (``/ 256``) are exact and
    not whole numbers, as the cells' CLAHE'd keyframes are not."""
    from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
    from meatmodeler_tpu_torch.ops import clahe

    scene = TurntableScene(image_size=(240, 180), focal=252.0, noise_sigma=1.0)
    raw = render_sequence(scene, 3, seed=0, color=False)[0][[0, 2]]
    return np.round(clahe.clahe(torch.from_numpy(raw.astype(np.float32))).numpy() * 256).astype(np.uint16)


def jax_reference(frames_u16: np.ndarray) -> dict:
    """The JAX package's features of each frame (``JAX_REFERENCE_KW``), the
    descriptors packed eight bits a byte. Written to ``JAX_REFERENCE`` by
    ``np.savez_compressed(JAX_REFERENCE, frames_u16=f, **jax_reference(f))``
    with ``f = jax_reference_frames()``."""
    import jax.numpy as jnp

    from meatmodeler_tpu.ops import orb as jorb

    outs = [jorb.detect_and_compute(jnp.asarray(f), **JAX_REFERENCE_KW) for f in frames_u16.astype(np.float32) / 256]
    ref = {k: np.stack([np.asarray(getattr(o, k)) for o in outs]) for k in ("xy", "response", "angle", "octave", "mask")}
    ref["descriptors"] = np.packbits(np.stack([np.asarray(o.descriptors) for o in outs]).astype(np.uint8), axis=-1)
    return ref


@pytest.fixture(scope="module")
def stored_reference():
    with np.load(JAX_REFERENCE) as data:
        return {k: data[k] for k in data.files}


def test_stored_reference_is_the_jax_packages(stored_reference):
    """The stored features are the JAX package's of the stored frames."""
    ref = jax_reference(stored_reference["frames_u16"])
    for key in ("xy", "octave", "mask", "descriptors"):
        np.testing.assert_array_equal(ref[key], stored_reference[key], err_msg=key)
    # XLA's float32 moment sums move with the backend's settings: 1.05e-5
    # rad between the tests' 8-device float64-enabled CPU backend, which
    # wrote the file, and a plain one.
    np.testing.assert_allclose(ref["angle"], stored_reference["angle"], rtol=0, atol=5e-5)
    np.testing.assert_allclose(ref["response"], stored_reference["response"], rtol=1e-5, atol=0)
    assert ref["mask"].sum() > 600


def test_plain_path_meets_the_stored_reference(stored_reference):
    """The plain path by the rules the card path is held to
    (``orb_bench.reference_agreement``)."""
    frames = torch.from_numpy(stored_reference["frames_u16"].astype(np.float32) / 256)
    a = orb_bench.reference_agreement(orb.detect_and_compute(frames, **JAX_REFERENCE_KW), stored_reference)
    assert a["ok"] and a["slots"] == 1.0 and a["bins_differ"] == 0, a


def test_reference_agreement_catches_a_changed_bit_angle_and_slot(stored_reference):
    frames = torch.from_numpy(stored_reference["frames_u16"].astype(np.float32) / 256)
    feats = orb.detect_and_compute(frames, **JAX_REFERENCE_KW)
    slot = int(np.flatnonzero(stored_reference["mask"][0])[0])
    desc = feats.descriptors.clone()
    desc[0, slot, 7] ^= 1
    assert not orb_bench.reference_agreement(feats._replace(descriptors=desc), stored_reference)["desc_equal"]
    angle = feats.angle.clone()
    angle[0, slot] += 2e-4
    assert not orb_bench.reference_agreement(feats._replace(angle=angle), stored_reference)["ok"]
    mask = feats.mask.clone()
    mask[0, np.flatnonzero(stored_reference["mask"][0])[:10]] = False
    assert orb_bench.reference_agreement(feats._replace(mask=mask), stored_reference)["slots"] < 0.99
