"""The relative pose's hypotheses, cheirality vote and candidate scoring:
the port's plain versions (``ransac.*_reference``, which the hand-written
kernels of ``csrc/relpose_hyp.cu`` are held to on the card) against the
JAX package's functions on the same seeded inputs, the dispatch that keeps
CPU tensors on the plain versions, the wrappers' refusals, the bench's work
counts and its agreement rules.

Inputs: seeded two-view scenes (``relpose_bench._scene``) of 64-256 slots
with masked (zeroed) slots, outliers and, in one, a NaN coordinate in a
slot out of the mask; 128-256 hypotheses drawn by the port's
``sample_subsets`` and handed to both packages. The JAX side runs under
``JAX_ENABLE_X64`` on arrays cast explicitly to each side's type
(``testing.f32`` for float32).

Tolerances. Float64 on both sides: the same algorithms, so essential
matrices (up to sign) within 1e-8 and homographies within 1e-8 of their
largest entry on every hypothesis whose sample has a unique null vector
(``relpose_bench._unique_null``: a sample with a repeated slot leaves the
vector to the solver), and consensus counts exactly wherever no slot in
the mask lies within 1e-6 of the gate (relative). Float32: on the
hypotheses float32 rounding does not decide (the port's float32 result
within 1e-5 of its float64 result, and a unique null vector), within 1e-3:
both sides solve the squared normal matrix in float32 (eigh), whose
vectors carry errors of eps / gap, and counts within 2% of the mask's
slots (a 1e-3 change of E moves distances near the gate). Poses after the
cheirality vote within 1e-4 where one decomposition has the most votes;
sorted votes equal. Scores: the good count equal, the truncated cost
within 1e-3 relative, poses within 1e-4, residuals within 1e-4 of (the
gate + the residual), on the candidates with a single most-voted
decomposition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meatmodeler_tpu.geometry import homography as jh
from meatmodeler_tpu.geometry import ransac as jr
from meatmodeler_tpu.geometry import so3 as jso3
from meatmodeler_tpu_torch.geometry import ransac as tr
from meatmodeler_tpu_torch.geometry import ransac_cuda, ransac_hyp_cuda
from meatmodeler_tpu_torch.testing import f32
from meatmodeler_tpu_torch.tools import relpose_bench as rb

torch.set_num_threads(2)

K = np.array([[1000.0, 0.0, 640.0], [0.0, 1000.0, 360.0], [0.0, 0.0, 1.0]])
# (slots, hypotheses, masked share, outlier share, NaN padding)
SCENES = {"dense": (128, 256, 0.1, 0.1, False), "sparse_nan": (256, 128, 0.7, 0.2, True)}


def _scene(name, seed=0):
    n, h, masked, outliers, nan = SCENES[name]
    rng = np.random.default_rng(seed)
    p1, p2 = rb._scene(rng, n, np.array([0.02, 0.15, -0.01]), np.array([-1.0, 0.05, 0.1]), K)
    out = rng.random(n) < outliers
    p2[out] = rng.uniform([0, 0], [1280, 720], size=(int(out.sum()), 2))
    mask = rng.random(n) >= masked
    p1[~mask] = 0.0
    p2[~mask] = 0.0
    if nan:
        p1[np.flatnonzero(~mask)[0], 0] = np.nan
    g = torch.Generator().manual_seed(seed)
    m = torch.from_numpy(mask)
    idx8 = tr.sample_subsets(m, h, 8, g).numpy()
    idx4 = tr.sample_subsets(m, h, 4, g).numpy()
    return p1, p2, mask, idx8, idx4


def _thr2(k, threshold=1.5):
    return (threshold / (0.5 * (k[0, 0] + k[1, 1]))) ** 2


def _cast(dtype, *xs):
    return [x.astype(dtype) if np.issubdtype(x.dtype, np.floating) else x for x in xs]


def _torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@jax.jit
def _jax_essential(p1, p2, mask, k, idx, thr2):
    """JAX's estimate_relative_pose lines 495-514: rays, Hartley
    normalisation, vmap(solve_one), Sampson consensus counts."""
    c, f = jnp.stack([k[0, 2], k[1, 2]]), jnp.stack([k[0, 0], k[1, 1]])
    n1, n2 = (p1 - c) / f, (p2 - c) / f
    n1h, t1 = jr._normalize(n1, mask)
    n2h, t2 = jr._normalize(n2, mask)
    es = jax.vmap(lambda a, b: jr._project_to_essential(t2.T @ jr._eight_point(a, b) @ t1))(n1h[idx], n2h[idx])
    one = jnp.ones_like(n1[:, :1])
    x1, x2 = jnp.concatenate([n1, one], 1), jnp.concatenate([n2, one], 1)
    d = jax.vmap(lambda e: jr._sampson(e, x1, x2))(es)
    return es, jnp.sum((d < thr2) & mask[None, :], axis=1)


@jax.jit
def _jax_homography(p1, p2, mask, idx, thr2):
    """JAX's find_homography_ransac lines 684-687: vmap(find_homography) and
    the transfer-error counts."""
    hs = jax.vmap(jh.find_homography)(p1[idx], p2[idx])
    d = jax.vmap(lambda h: jr._homography_transfer_sq(h, p1, p2))(hs)
    return hs, jnp.sum((d < thr2) & mask[None, :], axis=1)


_jax_recover = jax.jit(jax.vmap(jr.recover_pose, in_axes=(0, None, None, 0, None)))


@jax.jit
def _jax_score(rvs, tvs, p1, p2, mask, k, thr2):
    """JAX's estimate_relative_pose's ``score`` (lines 544-581), vmapped
    over the candidates, from the JAX package's own helpers."""
    c, f = jnp.stack([k[0, 2], k[1, 2]]), jnp.stack([k[0, 0], k[1, 1]])
    n1, n2 = (p1 - c) / f, (p2 - c) / f
    one = jnp.ones_like(n1[:, :1])
    x1, x2 = jnp.concatenate([n1, one], 1), jnp.concatenate([n2, one], 1)
    rthr2 = 4.0 * thr2

    def score(rv, tv):
        rot = jso3.exp(rv)
        tx = jnp.array([[0.0, -tv[2], tv[1]], [tv[2], 0.0, -tv[0]], [-tv[1], tv[0], 0.0]], tv.dtype)
        e = tx @ rot
        e = e / jnp.maximum(jnp.linalg.norm(e), 1e-12)
        res = jr._sampson(e, x1, x2)
        inl = (res < thr2) & mask
        rvd, tvd, _ = jr.recover_pose(e, p1, p2, inl, k)
        rd = jso3.exp(rvd)
        x3, z1, z2 = jr._triangulate_midpoint(rd, tvd, n1, n2)
        xc2 = x3 @ rd.T + tvd
        safe1 = jnp.where(jnp.abs(z1) > 1e-9, z1, 1e-9)
        safe2 = jnp.where(jnp.abs(z2) > 1e-9, z2, 1e-9)
        r1 = jnp.sum((x3[:, :2] / safe1[:, None] - n1) ** 2, axis=1)
        r2 = jnp.sum((xc2[:, :2] / safe2[:, None] - n2) ** 2, axis=1)
        rmax = jnp.maximum(r1, r2)
        good = mask & (z1 > 1e-6) & (z2 > 1e-6) & (rmax < rthr2)
        msac = jnp.sum(jnp.where(mask, jnp.minimum(rmax, rthr2), 0.0))
        return jnp.sum(good), msac, rvd, tvd, e, jnp.where(mask, res, jnp.inf), inl

    return jax.vmap(score)(rvs, tvs)


def _jax(fn, *xs):
    return [torch.from_numpy(np.array(o)) for o in fn(*(jnp.asarray(x) for x in xs))]


def _essential_both(name, dtype):
    p1, p2, mask, idx8, _ = _scene(name)
    p1, p2, k = _cast(dtype, p1, p2, K)
    thr2 = np.asarray(_thr2(k), dtype)
    jes, jc = _jax(_jax_essential, p1, p2, mask, k, idx8, thr2)
    tes, tc = tr.essential_hypotheses_reference(*_torch(p1, p2, mask, k, idx8, thr2))
    return (p1, p2, mask, k, idx8, thr2), (jes, jc), (tes, tc)


@pytest.mark.parametrize("name", list(SCENES))
def test_essential_hypotheses_reference_matches_jax(name):
    args64, (jes, jc), (tes, tc) = _essential_both(name, np.float64)
    t64 = tuple(_torch(*args64))
    unique = rb._unique_null(rb._sampson_normal(t64))
    assert int(unique.sum()) >= len(unique) // 2
    assert float(rb.sign_spread(tes, jes)[unique].max()) <= 1e-8
    x1 = tr._homog(tr._rays(t64[0], t64[3]))
    x2 = tr._homog(tr._rays(t64[1], t64[3]))
    _, decided = rb._decided_counts(tr._sampson(tes, x1, x2), t64[2], float(t64[5]), 1e-6)
    decided &= unique
    assert int(decided.sum()) >= len(decided) // 2
    assert torch.equal(tc[decided], jc[decided])
    # float32, on the hypotheses float32 rounding does not decide.
    _, (jes32, jc32), (tes32, tc32) = _essential_both(name, np.float32)
    assert tes32.dtype == torch.float32 and jes32.dtype == torch.float32
    held = (rb.sign_spread(tes32, tes) <= 1e-5) & unique
    assert int(held.sum()) >= 10
    assert float(rb.sign_spread(tes32, jes32)[held].max()) <= 1e-3
    assert int((tc32 - jc32).abs()[held].max()) <= max(1, int(0.02 * args64[2].sum()))


@pytest.mark.parametrize("name", list(SCENES))
def test_homography_hypotheses_reference_matches_jax(name):
    p1, p2, mask, _, idx4 = _scene(name)
    out = {}
    for dtype in (np.float64, np.float32):
        a, b = _cast(dtype, p1, p2)
        jhs, jc = _jax(_jax_homography, a, b, mask, idx4, np.asarray(9.0, dtype))
        ths, tc = tr.homography_hypotheses_reference(*_torch(a, b, mask, idx4), 3.0)
        out[dtype] = (jhs, jc, ths, tc)
    jhs, jc, ths, tc = out[np.float64]
    t64 = tuple(_torch(p1, p2, mask, idx4)) + (3.0,)
    unique = rb._unique_null(rb._dlt_normal(t64))
    assert float(rb.rel_spread(ths, jhs)[unique].max()) <= 1e-8
    d = tr._homography_transfer_sq(ths, t64[0], t64[1])
    _, decided = rb._decided_counts(d, t64[2], 9.0, 1e-6)
    decided &= unique
    assert int(decided.sum()) >= len(decided) // 2
    assert torch.equal(tc[decided], jc[decided])
    jhs32, jc32, ths32, _ = out[np.float32]
    held = (rb.rel_spread(ths32, ths) <= 1e-5) & unique
    assert int(held.sum()) >= 10
    assert float(rb.rel_spread(ths32, jhs32)[held].max()) <= 1e-3


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_recover_pose_reference_matches_jax(name, dtype):
    """The top 16 hypotheses' cheirality votes, each over its own Sampson
    inliers: batched and gated in the port (``thr2``), vmapped over
    pre-gated masks in JAX."""
    args, _, (tes, tc) = _essential_both(name, dtype)
    p1, p2, mask, k, _, thr2 = args
    top = torch.sort(tc, descending=True, stable=True).indices[:16]
    es = tes[top]
    x1 = tr._homog(tr._rays(*_torch(p1, k)))
    x2 = tr._homog(tr._rays(*_torch(p2, k)))
    inl = (tr._sampson(es, x1, x2) < torch.from_numpy(thr2)) & torch.from_numpy(mask)
    rv, tv, votes = tr.recover_pose_reference(es, *_torch(p1, p2, mask, k, thr2))
    rv2, tv2, votes2 = tr.recover_pose_reference(es, *_torch(p1, p2), inl, *_torch(k))
    for x, y in ((rv, rv2), (tv, tv2), (votes, votes2)):
        assert torch.equal(x, y)
    jrv, jtv, jvotes = _jax(_jax_recover, es.numpy(), p1, p2, inl.numpy(), k)
    assert torch.equal(torch.sort(votes, -1).values, torch.sort(jvotes, -1).values)
    unique = rb._unique_top(votes)
    assert int(unique.sum()) >= 12
    tol = 1e-4 if dtype == np.float32 else 1e-10
    assert float((rv - jrv).abs().amax(-1)[unique].max()) <= tol
    assert float((tv - jtv).abs().amax(-1)[unique].max()) <= tol


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("zero_t", [False, True])
def test_score_candidates_reference_matches_jax(name, zero_t):
    """24 candidates around the truth (some far off), as the refinement
    hands them over; with ``zero_t`` the last 8 have t = 0 (a failed
    homography decomposition's nan_to_num)."""
    p1, p2, mask, _, _ = _scene(name)
    rng = np.random.default_rng(7)
    rvs = np.array([0.02, 0.15, -0.01]) + rng.normal(scale=0.02, size=(24, 3))
    tvs = np.array([-1.0, 0.05, 0.1]) + rng.normal(scale=0.1, size=(24, 3))
    tvs /= np.linalg.norm(tvs, axis=1, keepdims=True)
    rvs[-3:] = rng.normal(size=(3, 3))
    if zero_t:
        tvs[16:] = 0.0
    rvs, tvs, p1, p2, k = _cast(np.float32, rvs, tvs, p1, p2, K)
    thr2 = np.asarray(_thr2(k), np.float32)
    got = tr.score_candidates_reference(*_torch(rvs, tvs, p1, p2, mask, k, thr2))
    ref = _jax(_jax_score, rvs, tvs, p1, p2, mask, k, thr2)
    good, msac, rvd, tvd, e, res, inl = got
    votes = tr.recover_pose_reference(e, *_torch(p1, p2), inl, *_torch(k))[2]
    unique = rb._unique_top(votes)
    assert int(unique.sum()) >= 12
    assert torch.equal(good[unique], ref[0][unique])
    np.testing.assert_allclose(msac[unique].numpy(), ref[1][unique].numpy(), rtol=1e-3)
    for x, y in ((rvd, ref[2]), (tvd, ref[3])):
        assert float((x - y).abs().amax(-1)[unique].max()) <= 1e-4
    torch.testing.assert_close(e, ref[4], atol=1e-6, rtol=0)
    assert torch.equal(torch.isinf(res), torch.isinf(ref[5]))
    fin = torch.isfinite(ref[5])
    assert float(((res - ref[5]).abs() / (float(thr2) + ref[5].abs()))[fin].max()) <= 1e-4
    assert torch.equal(inl, ref[6])


def test_homography_polish_reference_matches_jax_in_float64():
    """The polish in raw pixels, float64 on both sides, from the same draws:
    the same inliers; H maps them within 1e-2 px of JAX's H (the pixel
    normal matrix's condition, ~1e12, leaves H's entries to ~1e-5 of the
    largest even in float64); residuals within 1e-3 of (the gate + the
    residual); the 8 decompositions within 1e-4 as sets; also when a slot
    out of the mask holds a NaN (it poisons both polishes' normal matrices,
    which are then refused)."""
    for name in SCENES:
        p1, p2, mask, _, idx4 = _scene(name)
        jhs, jc = _jax(_jax_homography, p1, p2, mask, idx4, np.asarray(9.0))
        h, res, inl, rv, tv = tr.homography_polish_reference(*_torch(p1, p2, mask), jhs, jc, 3.0, torch.from_numpy(K))
        key = jax.random.PRNGKey(0)
        calls = []

        def draws(*_args, **_kwargs):
            calls.append(1)
            return jnp.asarray(idx4)

        real = jax.random.categorical
        jax.random.categorical = draws
        try:
            jres = jr.find_homography_ransac.__wrapped__(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), key,
                                                         num_hypotheses=idx4.shape[0])
        finally:
            jax.random.categorical = real
        assert calls
        jhm = torch.from_numpy(np.array(jres.matrix))
        assert torch.equal(inl, torch.from_numpy(np.array(jres.inliers))) and int(inl.sum()) >= 5
        q = torch.cat([torch.from_numpy(p1), torch.ones(len(p1), 1, dtype=torch.float64)], 1)[inl]
        mapped = [(q @ m.T)[:, :2] / (q @ m.T)[:, 2:] for m in (h, jhm)]
        assert float((mapped[0] - mapped[1]).abs().max()) <= 1e-2
        jr_res = torch.from_numpy(np.array(jres.residuals))
        assert torch.equal(torch.isinf(res), torch.isinf(jr_res))
        fin = torch.isfinite(jr_res)
        assert float(((res - jr_res).abs() / (9.0 + jr_res.abs()))[fin].max()) <= 1e-3
        jrv, jtv = (torch.from_numpy(np.array(x)) for x in jr._decompose_homography(jres.matrix, jnp.asarray(K)))
        assert rb._set_spread(torch.cat([rv, tv], 1), torch.cat([jrv, jtv], 1)) <= 1e-4


@pytest.mark.parametrize("name", list(SCENES))
def test_estimate_relative_pose_matches_jax_with_injected_draws(monkeypatch, name):
    """The whole estimate with the JAX draws injected (8-point at ``key``,
    4-point at ``fold_in(key, 1)``), on scenes with masked, outlier and NaN
    slots: the same pose (1e-3) and inliers (within 1% of the slots)."""
    p1, p2, mask, _, _ = _scene(name)
    p1, p2, k = f32(p1), f32(p2), f32(K)
    key = jax.random.PRNGKey(3)
    keys = {8: key, 4: jax.random.fold_in(key, 1)}

    def fake(m, num_hypotheses, size, generator):
        logits = jnp.where(jnp.asarray(m.numpy()), 0.0, -jnp.inf)
        idx = jax.random.categorical(keys[size], logits[None, :], shape=(num_hypotheses, size))
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    monkeypatch.setattr(tr, "sample_subsets", fake)
    rvj, tvj, rj = jr.estimate_relative_pose(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), jnp.asarray(k),
                                             key, num_hypotheses=256)
    rvt, tvt, rt = tr.estimate_relative_pose(*_torch(p1, p2, mask, k), num_hypotheses=256)
    np.testing.assert_allclose(rvt.numpy(), np.asarray(rvj), atol=1e-3)
    np.testing.assert_allclose(tvt.numpy(), np.asarray(tvj), atol=1e-3)
    assert int((rt.inliers.numpy() != np.asarray(rj.inliers)).sum()) <= max(1, int(0.01 * len(mask)))
    assert np.isinf(rt.residuals.numpy()[~mask]).all()


def test_estimate_relative_pose_calls_each_dispatch_point_once(monkeypatch):
    """One estimate: each of the five dispatch points once, the refinement
    once, and (on the CPU) no kernel library built or launched."""
    def no_build():
        raise AssertionError("a CUDA library was asked for on CPU tensors")

    monkeypatch.setattr(ransac_hyp_cuda, "build", no_build)
    monkeypatch.setattr(ransac_cuda, "build", no_build)
    calls = {}
    for name in (*rb.HYP_CALLS, "refine_relative_pose"):
        real = getattr(tr, name)

        def counted(*args, _name=name, _real=real, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(tr, name, counted)
    before = dict(ransac_hyp_cuda.LAUNCHES)
    p1, p2, mask, _, _ = _scene("dense")
    rv, tv, res = tr.estimate_relative_pose(*_torch(f32(p1), f32(p2), mask, f32(K)), num_hypotheses=128)
    assert calls == {name: 1 for name in (*rb.HYP_CALLS, "refine_relative_pose")}
    assert ransac_hyp_cuda.LAUNCHES == before and not ransac_hyp_cuda._LIB.loaded
    assert torch.isfinite(rv).all() and abs(float(torch.linalg.norm(tv)) - 1.0) < 1e-5
    assert int(res.num_inliers) > 50


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors every dispatch point is its plain version, bit for
    bit, and no library is built; recover_pose's leading batch shape and
    its per-candidate mask pass through."""
    def no_build():
        raise AssertionError("the CUDA library was asked for on CPU tensors")

    monkeypatch.setattr(ransac_hyp_cuda, "build", no_build)
    case = rb.hyp_case("odometry")
    for name, args in case.items():
        got, ref = getattr(tr, name)(*args), getattr(tr, f"{name}_reference")(*args)
        for x, y in zip(got, ref):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    es, p1, p2, m, k, thr2 = case["recover_pose"]
    masks = m.expand(16, -1).reshape(2, 8, -1)
    got = tr.recover_pose(es.reshape(2, 8, 3, 3), p1, p2, masks, k)
    ref = tr.recover_pose_reference(es, p1, p2, m, k)
    for x, y in zip(got, ref):
        assert x.shape[:2] == (2, 8)
        torch.testing.assert_close(x.reshape(y.shape), y, rtol=0, atol=0, equal_nan=True)


def test_kernel_wrappers_refuse_cpu_and_bad_inputs():
    """The wrappers launch on CUDA tensors only (never computing on the CPU
    themselves) and refuse misshapen or mistyped inputs before any launch."""
    case = rb.hyp_case("odometry")
    for name, args in case.items():
        with pytest.raises(ValueError, match="CUDA"):
            getattr(ransac_hyp_cuda, name)(*args)
    p1, p2, m, k, idx, thr2 = case["essential_hypotheses"]
    bad = [(p1[:, :1], p2, m, k, idx, thr2), (p1, p2, m.float(), k, idx, thr2), (p1, p2, m, k.double(), idx, thr2),
           (p1, p2, m, k, idx[:, :4], thr2), (p1, p2, m, k, idx.int(), thr2), (p1.int(), p2, m, k, idx, thr2)]
    for args in bad:
        with pytest.raises(ValueError):
            ransac_hyp_cuda.essential_hypotheses(*args)
    es, p1, p2, m, k, thr2 = case["recover_pose"]
    with pytest.raises(ValueError):
        ransac_hyp_cuda.recover_pose(es, p1, p2, m[None].expand(3, -1), k, thr2)
    with pytest.raises(ValueError):
        ransac_hyp_cuda.score_candidates(*case["score_candidates"][:4], m[:-1], k, thr2)
    with pytest.raises(ValueError):
        ransac_hyp_cuda.homography_polish(p1, p2, m, es[:, :2], torch.zeros(16, dtype=torch.int64), 3.0)


def test_recover_pose_gate_is_the_premasked_vote():
    """``thr2`` gates each candidate's voters by its own Sampson distance:
    the same as voting over the pre-gated (B, N) mask, in both types."""
    for dtype in (torch.float32, torch.float64):
        es, p1, p2, m, k, thr2 = (x.to(dtype) if x.is_floating_point() else x
                                  for x in rb.hyp_case("bootstrap")["recover_pose"])
        x1, x2 = tr._homog(tr._rays(p1, k)), tr._homog(tr._rays(p2, k))
        pre = (tr._sampson(es, x1, x2) < thr2) & m
        for x, y in zip(tr.recover_pose_reference(es, p1, p2, m, k, thr2), tr.recover_pose_reference(es, p1, p2, pre, k)):
            assert torch.equal(x, y)
        assert int(pre.sum(1).min()) > 100


def test_hyp_work_counts_the_masked_slots():
    """Operations grow with the slots in the mask, not with the slots."""
    case = rb.hyp_case("two_view")
    for name, args in case.items():
        w = rb.hyp_work(name, args)
        mask = args[rb._MASK_ARG[name]]
        n_valid = int(mask.sum())
        assert w["flops"] > 0 and w["bytes"] > mask.shape[-1]
        if name == "essential_hypotheses":
            assert w["flops"] == args[4].shape[0] * (rb.ESSENTIAL_SOLVE_OPS + rb.SAMPSON_OPS * n_valid)
        if name == "homography_hypotheses":
            assert w["flops"] == args[3].shape[0] * (rb.HOMOGRAPHY_SOLVE_OPS + rb.TRANSFER_OPS * n_valid)
    dense = rb.hyp_work("essential_hypotheses", rb.hyp_case("odometry")["essential_hypotheses"])
    assert dense["flops"] < 1024 * (rb.ESSENTIAL_SOLVE_OPS + rb.SAMPSON_OPS * 128)


def test_agreement_rules_hold_the_plain_version_to_itself():
    """Each agreement passes the plain version held to itself at a path's
    shape and at the edges (a NaN slot out of the mask; zero-t candidates),
    with held items to hold; a perturbed result fails it."""
    for label in ("odometry", *rb.HYP_EDGES):
        for name, args in rb.hyp_case(label).items():
            plain = getattr(tr, f"{name}_reference")
            ref, ref64 = plain(*args), plain(*rb._as64(args))
            a = rb.AGREEMENT[name](args, ref, ref64, ref, ref64)
            assert rb.hyp_agrees(name, a), (label, name, a)
    args = rb.hyp_case("odometry")["essential_hypotheses"]
    es, counts = tr.essential_hypotheses_reference(*args)
    es64, counts64 = tr.essential_hypotheses_reference(*rb._as64(args))
    a = rb.essential_agreement(args, (es + 1e-3, counts), (es64, counts64), (es, counts), (es64, counts64))
    assert not rb.hyp_agrees("essential_hypotheses", a)
    a = rb.essential_agreement(args, (es, counts + 1), (es64, counts64), (es, counts), (es64, counts64))
    assert not rb.hyp_agrees("essential_hypotheses", a)


def test_unique_null_flags_repeated_slots():
    """A sample with a repeated slot has a null space of two: not held."""
    p1, p2, mask, idx8, _ = _scene("dense")
    idx8[0, 1] = idx8[0, 0]
    args = tuple(_torch(p1, p2, mask, K, idx8, np.asarray(_thr2(K))))
    unique = rb._unique_null(rb._sampson_normal(args))
    distinct = torch.tensor([len(set(r.tolist())) == 8 for r in idx8])
    assert not bool(unique[0]) and torch.equal(unique[distinct], torch.ones(int(distinct.sum()), dtype=torch.bool))


def test_relpose_paths_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA")
    from meatmodeler_tpu_torch.tools import relpose_paths

    assert relpose_paths.main([]) == 2
