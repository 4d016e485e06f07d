"""Pyramidal Lucas-Kanade: the port's plain version against the JAX
package's ``lucas_kanade`` at the settings of its three callers and at the
edge cases the hand-written kernel (``csrc/klt.cu``) must reproduce, the
early-exit argument the kernel rests on, and the dispatch that keeps CPU
tensors on the plain version.

Tolerances as ``test_torch_color_klt.py::test_pyramid_and_lucas_kanade``:
status equal, points 1e-3 px, window error 1e-3 (0..255 scale), NaN
pattern equal. The kernel itself is held to the plain version on the card
in ``test_torch_cuda_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu.ops import features as jfeat
from meatmodeler_tpu.ops import klt as jklt
from meatmodeler_tpu_torch.ops import klt as tklt
from meatmodeler_tpu_torch.ops import klt_cuda
from meatmodeler_tpu_torch.testing import blob_texture, lk_edge_points, pair, tt

torch.set_num_threads(2)

# The callers' settings: the device keyframe scan and the odometry (the
# keyframe config: win 21, 4 levels, 10 iterations, padding entries
# masked), and two_view's sub-pixel polish (win 15, one level, seeded at
# the match offset, the default 30 iterations).
SCAN = dict(win=21, levels=4, max_iters=10, eps=0.01)
TWO_VIEW = dict(win=15, levels=1, max_iters=30, eps=0.01)


def edge_points(img, n_interior=3):
    """The 19 edge-case points of ``img``, then its ``n_interior``
    strongest corners."""
    interior = np.asarray(jfeat.good_features(img, max_corners=n_interior).xy)
    return np.concatenate([lk_edge_points(*img.shape), interior])


def _case(name):
    """(prev, curr, points, mask, initial_flow or None, settings)."""
    if name in ("scan", "scan_edges"):
        h, w = 180, 320
        a, b = blob_texture(h=h, w=w), blob_texture(dx=3.4, dy=-2.2, h=h, w=w)
        pts = np.asarray(jfeat.good_features(a, max_corners=128).xy) if name == "scan" else edge_points(a)
        mask = np.ones(len(pts), bool)
        mask[::9] = False  # padding entries
        return a, b, pts, mask, None, SCAN
    h, w = 240, 320
    a, b = blob_texture(h=h, w=w, seed=4), blob_texture(dx=6.3, dy=4.6, h=h, w=w, seed=4)
    pts = np.asarray(jfeat.good_features(a, max_corners=96).xy) if name == "two_view" else edge_points(a)
    rng = np.random.default_rng(7)
    # Match offsets: the true shift to within a pixel, as ORB gives it.
    flow = (np.array([6.3, 4.6]) + rng.uniform(-0.8, 0.8, size=(len(pts), 2))).astype(np.float32)
    mask = rng.random(len(pts)) > 0.2
    if name == "two_view_edges":
        flow[3] = np.nan  # a NaN offset
        mask[19:] = True
    return a, b, pts, mask, flow, TWO_VIEW


def _both(name):
    a, b, pts, mask, flow, s = _case(name)
    n_lvl = s["levels"]
    pj1, pj2 = tuple(jklt.build_pyramid(jnp.asarray(a), n_lvl)), tuple(jklt.build_pyramid(jnp.asarray(b), n_lvl))
    pt1, pt2 = tklt.build_pyramid(tt(a), n_lvl), tklt.build_pyramid(tt(b), n_lvl)
    pts, pts_t = pair(pts)
    jflow = None if flow is None else jnp.asarray(flow)
    tflow = None if flow is None else tt(flow)
    ref = jklt.lucas_kanade(pj1, pj2, jnp.asarray(pts), point_mask=jnp.asarray(mask), initial_flow=jflow, **s)
    got = tklt.lucas_kanade_reference(pt1, pt2, pts_t, point_mask=torch.from_numpy(mask), initial_flow=tflow, **s)
    return ref, got, pts


@pytest.mark.parametrize("name", ["scan", "scan_edges", "two_view", "two_view_edges"])
def test_lucas_kanade_reference_matches_jax(name):
    ref, got, pts = _both(name)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), atol=1e-3)
    err_j, err_t = np.asarray(ref.error), got.error.numpy()
    np.testing.assert_array_equal(np.isnan(err_t), np.isnan(err_j))
    np.testing.assert_allclose(err_t[~np.isnan(err_t)], err_j[~np.isnan(err_j)], atol=1e-3)
    if name in ("scan", "two_view"):
        assert got.status.numpy().sum() >= 0.6 * len(pts)
    else:
        # Every NaN or far-off point fails; the interior corners track.
        status = got.status.numpy()
        assert not status[12:19].any()
        assert status[19:].all()


def test_frozen_point_stays_bit_identical():
    """The kernel leaves a point's iteration loop once it freezes. That is
    exact: a point whose displacement did not change in iteration k + 1
    keeps it, bit for bit, through any number of further iterations."""
    a, b, pts, mask, _, _ = _case("scan")
    p1, p2 = tklt.build_pyramid(tt(a), 1), tklt.build_pyramid(tt(b), 1)
    pts_t, mask_t = tt(pts), torch.from_numpy(mask)
    runs = [
        tklt.lucas_kanade_reference(p1, p2, pts_t, win=21, levels=1, max_iters=k, point_mask=mask_t).points.numpy()
        for k in range(1, 17)
    ]
    frozen_early = 0
    for k in range(len(runs) - 5):
        frozen = np.all(runs[k] == runs[k + 1], axis=1)
        frozen_early += int(frozen.sum()) if k < 6 else 0
        for j in range(2, 6):
            np.testing.assert_array_equal(runs[k + j][frozen], runs[k][frozen])
    assert frozen_early > 0


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors ``lucas_kanade`` is the plain version: the kernel's
    library is neither built nor loaded, and no launch is counted."""

    def no_build():
        raise AssertionError("the CUDA library was asked for on CPU tensors")

    monkeypatch.setattr(klt_cuda, "build", no_build)
    before = dict(klt_cuda.LAUNCHES)
    a, b, pts, mask, flow, s = _case("two_view")
    p1, p2 = tklt.build_pyramid(tt(a), 1), tklt.build_pyramid(tt(b), 1)
    args = (p1, p2, tt(pts))
    kw = dict(point_mask=torch.from_numpy(mask), initial_flow=tt(flow), **s)
    got, ref = tklt.lucas_kanade(*args, **kw), tklt.lucas_kanade_reference(*args, **kw)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert klt_cuda.LAUNCHES == before
    assert klt_cuda._LIB.loaded is False


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only; it never computes on the
    CPU itself."""
    pyr = tklt.build_pyramid(torch.zeros(32, 32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        klt_cuda.lk_track(pyr, pyr, torch.zeros(4, 2), win=7, levels=2, max_iters=3, eps=0.01)


def _read_pixels(shape, centre, pad, size):
    """The pixels (y, x) a size x size bilinear window around ``centre``
    reads from an image of ``shape`` edge-padded by ``pad``, its start
    clamped into the padded image, each index clamped into the image."""
    h, w = shape
    start = []
    for c, n_px in ((centre[1], h), (centre[0], w)):
        t0 = math.floor((c - 0.5 * (size - 1)) + pad)
        start.append(min(max(t0, 0), n_px + 2 * pad - size - 1) - pad)
    return {(min(max(start[0] + i, 0), h - 1), min(max(start[1] + j, 0), w - 1))
            for i in range(size + 1) for j in range(size + 1)}


def test_lk_work_counts_this_calls_iterations():
    """The bound counts the iterations each point ran (after early exit),
    the final error only where the status holds, and as bytes the union of
    the pixels the windows read at each level of each frame; the steps are
    the slowest point's chain at each level, coarsest first (staging and
    G, then one an iteration)."""
    from meatmodeler_tpu_torch.tools.klt_bench import lk_work

    shapes = [(180, 320), (90, 160), (45, 80), (23, 40)]
    win, px, tpl, io = 15, 15 * 15, 17 * 17, 9 + 13
    points = torch.tensor([[100.25, 80.5], [100.25, 80.5], [-50.0, 5.0]])
    iterations = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0], [10, 10, 10, 10]], dtype=torch.int32)
    path = torch.zeros((3, 4, 10, 2))
    path[0, 0, 0] = torch.tensor([3.0, -1.5])
    path[2, :, :, 0] = torch.linspace(0.0, 20.0, 10)
    tracked = points + torch.tensor([[3.0, -1.5], [0.0, 0.0], [0.0, 0.0]])
    status = torch.tensor([True, False, False])
    work = lk_work(shapes, points, win, iterations, path, tracked, status, with_flow=False)
    assert work["flops"] == 3 * 4 * (11 * tpl + 10 * px) + 50 * 16 * px + 1 * 25 * px
    pixels = 0
    for lvl, shape in enumerate(shapes):
        at = (points / 2**lvl).tolist()
        prev = set().union(*(_read_pixels(shape, c, win + 3, win + 2) for c in at))
        curr = set().union(*(_read_pixels(shape, (c[0] + d[0], c[1] + d[1]), win + 1, win)
                             for c, p, k in zip(at, path[:, lvl].tolist(), iterations[:, lvl].tolist())
                             for d in p[:k]))
        if lvl == 0:
            prev |= _read_pixels(shape, at[0], win + 1, win)
            curr |= _read_pixels(shape, tracked[0].tolist(), win + 1, win)
        pixels += len(prev) + len(curr)
    assert work["bytes"] == 4 * pixels + 3 * io
    assert work["steps"] == [12, 12, 12, 12]
    assert lk_work(shapes, points[:2], win, iterations[:2], path[:2], tracked[:2], status[:2], False)["steps"] == [
        6, 5, 4, 3]
    # One interior point, one iteration where it started, at full
    # resolution: its template grid and one window; its error windows lie
    # inside those, so tracking it adds no bytes.
    one = lk_work(shapes[:1], points[:1], win, iterations[:1, :1], torch.zeros((1, 1, 10, 2)), points[:1],
                  torch.tensor([False]), with_flow=True)
    assert one["bytes"] == 4 * ((win + 3) ** 2 + (win + 1) ** 2) + 17 + 13
    tracked_one = lk_work(shapes[:1], points[:1], win, iterations[:1, :1], torch.zeros((1, 1, 10, 2)), points[:1],
                          torch.tensor([True]), with_flow=True)
    assert tracked_one["bytes"] == one["bytes"]


def test_lk_agreement_holds_live_points_to_eps():
    """Status and NaN patterns count everywhere; the eps bound on every
    entry of a call that starts each point where it is, and on the live
    entries of a call seeded with offsets: only there may a padding entry
    differ by pixels."""
    from meatmodeler_tpu_torch.tools.klt_bench import held_entries, lk_agreement, lk_agrees

    ref = tklt.FlowResult(
        torch.tensor([[10.0, 10.0], [20.0, 20.0], [float("nan"), 5.0], [30.0, 30.0]]),
        torch.tensor([True, False, False, False]),
        torch.tensor([1.5, float("nan"), float("nan"), float("nan")]),
    )
    got = ref._replace(points=ref.points + torch.tensor([[2e-5, 0.0], [30.0, 0.0], [0.0, 0.0], [0.0, 0.0]]))
    mask = torch.tensor([True, False, True, False])
    flow = torch.zeros(4, 2)
    held = held_entries(ref.points, mask, flow)
    assert held.tolist() == [True, False, True, False]
    assert held_entries(ref.points, mask, None).all() and held_entries(ref.points, None, flow).all()
    a = lk_agreement(got, ref, held)
    assert a["status_equal"] and a["nan_equal"] and lk_agrees(a, 0.01)
    assert a["max_point_not_held"] == 30.0 and a["not_held"] == 2 and a["held"] == 2
    assert a["max_point"] == pytest.approx(2e-5, rel=1e-2)
    assert not lk_agrees(lk_agreement(got, ref, held_entries(ref.points, mask, None)), 0.01)
    assert not lk_agrees(lk_agreement(got._replace(status=~ref.status), ref, held), 0.01)
    assert not lk_agrees(lk_agreement(got._replace(error=ref.error + 1e-3), ref, held), 0.01)
    moved = got._replace(points=got.points + torch.tensor([[0.02, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]))
    assert not lk_agrees(lk_agreement(moved, ref, held), 0.01)


def test_lk_cases_cover_the_kernels_edges():
    """The card's new edge cases: 129 points (one past the scan's) and the
    edge points at win 31 through 8 levels, the largest window and depth
    the kernel takes."""
    from meatmodeler_tpu_torch.ops import klt_cuda
    from meatmodeler_tpu_torch.tools.klt_bench import lk_case

    prev, _, pts, mask, flow, s = lk_case("ragged", torch.device("cpu"))
    assert len(pts) == 129 and flow is None
    prev, _, pts, mask, flow, s = lk_case("deep_edges", torch.device("cpu"))
    assert (s["win"], s["levels"]) == (klt_cuda.MAX_WIN, klt_cuda.MAX_LEVELS) and len(prev) == 8
    assert len(pts) == 35 and bool(mask[:19].all())


def test_klt_bench_refuses_without_cuda():
    from meatmodeler_tpu_torch.tools import klt_bench

    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")
    assert klt_bench.main([]) == 2
