"""Relative-pose refinement: the port's plain version against the JAX
package's ``refine_relative_pose`` at the shapes of its three callers and
at the edge cases the hand-written kernel (``csrc/relpose.cu``) must
reproduce, the dispatch that keeps CPU tensors on the plain version, the
wrapper's refusals and the bench's work count.

Tolerances. In float64 the two packages run the same algorithm to within
1e-9 on every candidate, so there every candidate is held to 1e-6. In
float32, 15 Levenberg-Marquardt iterations amplify rounding: a candidate
still far from its optimum, or on a flat stretch of the cost, crosses
accept/reject decisions that differ by a rounding, and then its damping and
path differ (far-off starts land up to 0.1 apart between the two packages,
as between any two summation orders). So float32 results are held to 1e-4
on the candidates that float32 rounding does not decide: those whose
float32 result lies within 1e-5 of the same call in float64
(``relpose_bench.determined``); the rest are held to equal NaN patterns.
The kernel itself is held to the plain version the same way, on the card,
in ``test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meatmodeler_tpu.geometry import ransac as jr
from meatmodeler_tpu_torch.geometry import ransac as tr
from meatmodeler_tpu_torch.geometry import ransac_cuda
from meatmodeler_tpu_torch.tools import relpose_bench
from meatmodeler_tpu_torch.tools.relpose_bench import (
    EDGE_CASES,
    caller_case,
    determined,
    relpose_agreement,
    relpose_agrees,
    relpose_case,
    relpose_work,
)

torch.set_num_threads(2)

# The callers' shapes (odometry: 16 essential and 8 homography candidates
# at 128 points) and a masked, outlier-heavy N=512 call, then the edge cases.
CASES = ["odometry", "odometry_h", "n512", *EDGE_CASES]
_jax_refine = jax.jit(jax.vmap(jr.refine_relative_pose, in_axes=(0, 0, None, None, None, None)))


def _case(name):
    if name in ("odometry", "odometry_h"):
        return caller_case(name)
    if name == "n512":
        return relpose_case("scene", 16, 512, masked=0.7, outliers=0.3, seed=1)
    return relpose_case(name)


def _f64(case):
    return tuple(x.astype(np.float64) if x.dtype == np.float32 else x for x in case)


def _plain(case):
    return tr.refine_relative_pose_reference(*(torch.from_numpy(np.ascontiguousarray(x)) for x in case))


def _jax(case):
    return tuple(torch.from_numpy(np.asarray(x)) for x in _jax_refine(*(jnp.asarray(x) for x in case)))


@pytest.mark.parametrize("name", CASES)
def test_refine_reference_matches_jax(name):
    case = _case(name)
    # float64: every candidate, the same algorithm.
    got64, ref64 = _plain(_f64(case)), _jax(_f64(case))
    assert ref64[0].dtype == torch.float64
    for g, r in zip(got64, ref64):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0, equal_nan=True)
    # float32: the candidates rounding does not decide.
    got, ref = _plain(case), _jax(case)
    assert ref[0].dtype == torch.float32
    held = determined(got, got64)
    a = relpose_agreement(ref, got, held)
    assert relpose_agrees(a, 1e-4), a
    assert a["held"] >= len(case[0]) // 2, a


def test_refine_reference_edge_semantics():
    """What the kernel must reproduce at the edges: an empty mask leaves
    every start where it was (NaN weights, every step refused), with t made
    unit; a zero t stays zero through the 1e-12 clamp; small and near-pi
    rotations come out finite."""
    rv0, tv0, *rest = relpose_case("all_masked")
    rv, tv = _plain((rv0, tv0, *rest))
    np.testing.assert_array_equal(rv.numpy(), rv0)
    np.testing.assert_allclose(tv.numpy(), tv0 / np.linalg.norm(tv0, axis=1, keepdims=True), rtol=1e-6)
    rv0, tv0, *rest = relpose_case("zero_t")
    rv, tv = _plain((rv0, tv0, *rest))
    assert (tv[:3] == 0).all() and (rv[:3].numpy() == rv0[:3]).all()
    np.testing.assert_allclose(torch.linalg.norm(tv[3:], dim=1).numpy(), 1.0, rtol=1e-5)
    for name in ("small_angle", "near_pi"):
        rv, tv = _plain(relpose_case(name))
        assert torch.isfinite(rv).all() and torch.isfinite(tv).all()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors ``refine_relative_pose`` is the plain version: the
    kernel's library is neither built nor loaded, and no launch is
    counted; a leading batch shape passes through."""

    def no_build():
        raise AssertionError("the CUDA library was asked for on CPU tensors")

    monkeypatch.setattr(ransac_cuda, "build", no_build)
    before = dict(ransac_cuda.LAUNCHES)
    rv0, tv0, *rest = (torch.from_numpy(x) for x in caller_case("odometry_h"))
    got = tr.refine_relative_pose(rv0.reshape(2, 4, 3), tv0.reshape(2, 4, 3), *rest)
    ref = tr.refine_relative_pose_reference(rv0, tv0, *rest)
    for x, y in zip(got, ref):
        assert x.shape == (2, 4, 3)
        torch.testing.assert_close(x.reshape(8, 3), y, rtol=0, atol=0, equal_nan=True)
    assert ransac_cuda.LAUNCHES == before
    assert ransac_cuda._LIB.loaded is False


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only, never computing on the CPU
    itself, and refuses misshapen or mistyped inputs."""
    args = [torch.from_numpy(x) for x in caller_case("odometry_h")]
    with pytest.raises(ValueError, match="CUDA"):
        ransac_cuda.refine_relpose(*args)
    for i, bad in ((0, args[0][None]), (1, args[1][:4]), (3, args[3][:-1]), (4, args[4].float()),
                   (5, args[5].double())):
        with pytest.raises(ValueError, match="expected|needs"):
            ransac_cuda.refine_relpose(*args[:i], bad, *args[i + 1:])


def test_relpose_work_counts_the_masked_points():
    """Operations for the points in the mask, every candidate and
    iteration; bytes for every slot; the block's dependent steps at most
    (two compaction passes and the start's residuals, then per iteration
    the pose's tangents, four radix passes and a scan, the normal
    equations, the solve and the candidate's cost) and its block barriers
    at most (three, then per iteration five for the median, one after the
    sums and one after the cost), whatever the median's parity."""
    w = relpose_work(16, 128, 115, 15)
    assert w["flops"] == 8 * 115 + 16 * 15 * (395 * 115 + 700)
    assert w["bytes"] == 128 * 17 + 16 * 24 + 36 + 16 * 24
    assert w["steps"] == 3 + 15 * 9
    assert w["barriers"] == 3 + 15 * 7
    assert relpose_work(16, 128, 114, 15)["steps"] == 3 + 15 * 9
    assert relpose_work(24, 8192, 421, 1)["steps"] == 3 + 9
    assert relpose_work(8, 64, 0, 15)["flops"] == 8 * 15 * 700


# The compaction (``csrc/relpose.cu``) drops the masked-out slots that add
# exactly 0 to every sum. These pin, on the plain version and the JAX
# package's, what that relies on, on a masked, outlier-heavy 512-slot scene.
def _masked_scene(pad=None):
    case = relpose_case("scene", 8, 512, masked=0.7, outliers=0.2, seed=4)
    if pad is not None:
        relpose_bench.pad_slots(pad, case[2], case[3], case[4])
    return case


def test_refine_on_the_masks_slots_alone_matches_all_slots():
    """With finite padding, refining on the slots in the mask alone gives
    the poses refining on every slot gives: in float64 within 1e-8 on
    every candidate (the padding adds exact zeros, but torch.matmul blocks
    the sums differently for another N, so not bit for bit); in float32
    within 1e-4 on the candidates rounding does not decide."""
    rv, tv, p1, p2, m, k = _masked_scene()
    alone = (rv, tv, p1[m], p2[m], m[m], k)
    every64, alone64 = _plain(_f64((rv, tv, p1, p2, m, k))), _plain(_f64(alone))
    for x, y in zip(every64, alone64):
        torch.testing.assert_close(x, y, atol=1e-8, rtol=0)
    every = _plain((rv, tv, p1, p2, m, k))
    a = relpose_agreement(_plain(alone), every, determined(every, every64))
    assert relpose_agrees(a, 1e-4), a
    kept = ransac_cuda.kept_slots(*(torch.from_numpy(x) for x in (p1, p2, m, k)))
    assert torch.equal(kept, torch.from_numpy(m))


def test_nan_in_a_masked_out_slot_refuses_every_step():
    """A NaN coordinate in one masked-out slot makes its residual, weight
    and so every sum NaN: the plain version and the JAX package's refuse
    every step and return the starts (t made unit). The compaction keeps
    such a slot."""
    case = _masked_scene("nan")
    rv0, tv0, p1, p2, m, k = case
    unit = tv0 / np.linalg.norm(tv0, axis=1, keepdims=True)
    for rv, tv in (_plain(case), _jax(case)):
        np.testing.assert_array_equal(rv.numpy(), rv0)
        np.testing.assert_allclose(tv.numpy(), unit, rtol=1e-6)
    kept = ransac_cuda.kept_slots(*(torch.from_numpy(x) for x in (p1, p2, m, k)))
    assert int(kept.sum()) == int(m.sum()) + 1 and bool(kept[np.flatnonzero(~m)[0]])


def test_big_coordinate_in_a_masked_out_slot_matches_jax():
    """1e20 in one coordinate of each of four masked-out slots: the plain
    version gives what the JAX package gives (float64 within 1e-6, float32
    within 1e-4 where rounding does not decide), and what it gives with the
    padding at 0: bit for bit in both types, so such a slot does not poison
    the sums (its residual stays ~focal, its weight 0). The compaction
    keeps the four all the same: their rays lie beyond its bound."""
    case = _masked_scene("big")
    got64, ref64 = _plain(_f64(case)), _jax(_f64(case))
    for g, r in zip(got64, ref64):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0, equal_nan=True)
    got = _plain(case)
    a = relpose_agreement(_jax(case), got, determined(got, got64))
    assert relpose_agrees(a, 1e-4), a
    zero = _masked_scene()
    for x, y in zip(got + got64, _plain(zero) + _plain(_f64(zero))):
        assert torch.equal(x, y)
    kept = ransac_cuda.kept_slots(*(torch.from_numpy(x) for x in case[2:]))
    assert int(kept.sum()) == int(case[4].sum()) + 4


def test_relpose_agreement_holds_determined_candidates():
    """NaN patterns count everywhere; the bound on the candidates float32
    rounding does not decide, of which there must be one."""
    ref = (torch.tensor([[0.1, 0.2, 0.3], [1.0, 1.0, 1.0], [float("nan"), 0.0, 0.0]]), torch.zeros(3, 3))
    ref64 = (ref[0].double() + torch.tensor([[1e-6], [1e-3], [0.0]], dtype=torch.float64), ref[1].double())
    held = determined(ref, ref64)
    assert held.tolist() == [True, False, True]
    got = (ref[0] + torch.tensor([[5e-5], [0.3], [0.0]]), ref[1])
    a = relpose_agreement(got, ref, held)
    assert a["nan_equal"] and a["held"] == 2 and relpose_agrees(a, 1e-4)
    assert a["max_not_held"] == pytest.approx(0.3, rel=1e-5)
    assert not relpose_agrees(relpose_agreement((ref[0] + 2e-4, ref[1]), ref, held), 1e-4)
    assert not relpose_agrees(relpose_agreement((ref[0].nan_to_num(), ref[1]), ref, held), 1e-4)
    assert not relpose_agrees(relpose_agreement(got, ref, torch.tensor([False, False, False])), 1e-4)


def test_relpose_bench_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")
    assert relpose_bench.main([]) == 2
