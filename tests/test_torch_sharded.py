"""The port's device mesh (``meatmodeler_tpu_torch.parallel.sharded``) on
virtual CPU shards (``devices=["cpu"] * n``, the port's counterpart of the
suite's 8 virtual JAX CPU devices), against the JAX package.

Where JAX's sharded function compiles quickly (``adjust_points``' memory
band, ``make_mesh``) the port is held to it (``process_batch`` with a mesh:
``test_torch_batch.py``, which has JAX's pipeline compiled); elsewhere (its sharded BA and matching tests are slow-marked) to
JAX's unsharded function, with the bounds of ``tests/test_sharding.py``:

- point-sharded BA against the unsharded solve: rmse rtol 1e-4, cameras
  atol 1e-4, points atol 1e-3, equal iterations (the same LM trajectory up
  to the summation order of the reduced sums);
- sharded ``adjust_points`` against the unsharded one: rmse rtol 1e-4,
  points atol 5e-3 (both stop at ftol 1e-4; JAX also pads the sharded
  problem to its bucket, which moves its partition);
- data-parallel BA: every lane's rmse within 1e-4 of JAX's ``solve_ba`` on
  that problem, and equal to the port's one-device batched solve (same
  per-lane arithmetic) within 1e-6;
- tensor-parallel matching: good mask and indices exact;
- sharded preprocessing: equal to the one-device ``enhanced_grey`` of the
  port (CLAHE is per image), and to JAX's within 1e-3 on 99.99% of pixels
  (the cube-root rounding of ``test_torch_color_klt.py``).
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meatmodeler_tpu.config import SolverConfig as JaxSolverConfig
from meatmodeler_tpu.geometry import projection as jproj
from meatmodeler_tpu.ops import clahe as jclahe
from meatmodeler_tpu.ops import matching as jmatching
from meatmodeler_tpu.parallel import sharded as jsharded
from meatmodeler_tpu.solvers import bundle_adjust as jba
from meatmodeler_tpu_torch import cli
from meatmodeler_tpu_torch.io.synthetic import render_sequence
from meatmodeler_tpu_torch.ops import clahe as tclahe
from meatmodeler_tpu_torch.ops import matching as tmatching
from meatmodeler_tpu_torch.parallel import batch as tbatch
from meatmodeler_tpu_torch.parallel import sharded
from meatmodeler_tpu_torch.solvers import bundle_adjust as tba
from meatmodeler_tpu_torch.testing import from_fields
from test_sharding import make_ba_problem
from test_torch_batch import TINY_SCENE

torch.set_num_threads(2)


def cpus(n):
    return ["cpu"] * n


def to_torch(problem):
    """A JAX-side BAProblem as the port's (float32, int64 indices)."""
    return tba.BAProblem(*(None if x is None else torch.from_numpy(np.array(x)) for x in problem))._replace(
        frame_idx=torch.from_numpy(np.asarray(problem.frame_idx, np.int64)),
        point_idx=torch.from_numpy(np.asarray(problem.point_idx, np.int64)),
    )


@pytest.mark.parametrize("data,model", [(None, 1), (4, 2), (None, 2), (2, 1), (1, 8)])
def test_make_mesh_shapes_match_jax(data, model):
    mesh = sharded.make_mesh(data=data, model=model, devices=cpus(8))
    assert mesh.shape == dict(jsharded.make_mesh(data=data, model=model).shape)
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    with pytest.raises(AssertionError):
        sharded.make_mesh(data=3, model=3, devices=cpus(8))


def test_make_mesh_needs_cuda_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.make_mesh()


def test_collectives_on_one_device_and_refusals():
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    total = sharded.all_reduce_sum(parts)
    assert len(total) == 4 and all(torch.equal(t, torch.full((2, 3), 6.0)) for t in total)
    assert all(torch.equal(p, torch.full((2, 3), float(i))) for i, p in enumerate(parts))  # inputs untouched
    gathered = sharded.all_gather(parts)
    assert all(torch.equal(g, torch.stack(parts)) for g in gathered)
    # A GPU beside the CPU is neither one device nor distinct GPUs.
    with pytest.raises(ValueError, match="distinct GPUs"):
        sharded.all_reduce_sum([torch.zeros(2), torch.zeros(2, device="meta")])


@pytest.fixture(scope="module")
def eight_problems():
    return [make_ba_problem(s) for s in range(8)]


def test_solve_ba_batch_over_data(eight_problems):
    batched = to_torch(jax.tree.map(lambda *xs: jnp.stack(xs), *eight_problems))
    res = sharded.solve_ba_batch(sharded.make_mesh(data=4, devices=cpus(4)), batched)
    one = tba.solve_ba_batch(batched)
    np.testing.assert_array_equal(res.iterations.numpy(), one.iterations.numpy())
    for name in ("cam_params", "points", "rmse", "cost"):
        np.testing.assert_allclose(getattr(res, name).numpy(), getattr(one, name).numpy(), rtol=0, atol=1e-6)
    for i in range(8):
        local = jba.solve_ba(eight_problems[i])
        np.testing.assert_allclose(float(res.rmse[i]), float(local.rmse), rtol=1e-4)


@pytest.mark.parametrize("data,model", [(4, 1), (4, 2)])
def test_point_sharded_weighted_and_masked(data, model):
    problem = make_ba_problem(7, n_frames=4, n_points=100, n_obs=512)
    rng = np.random.default_rng(3)
    weight = rng.uniform(0.5, 2.0, 512).astype(np.float32)
    mask = np.asarray(problem.mask).copy()
    mask[::7] = False
    problem = problem._replace(weight=jnp.asarray(weight), mask=jnp.asarray(mask))
    mesh = sharded.make_mesh(data=data, model=model, devices=cpus(8))
    res_sh = sharded.solve_ba_point_sharded(mesh, to_torch(problem))
    res_1 = tba.solve_ba(to_torch(problem))
    jres = jba.solve_ba(problem)
    assert res_sh.iterations == res_1.iterations
    np.testing.assert_allclose(float(res_sh.rmse), float(res_1.rmse), rtol=1e-4)
    np.testing.assert_allclose(res_sh.cam_params.numpy(), res_1.cam_params.numpy(), atol=1e-4)
    np.testing.assert_allclose(res_sh.points.numpy(), res_1.points.numpy(), atol=1e-3)
    np.testing.assert_allclose(float(res_sh.rmse), float(jres.rmse), rtol=1e-4)
    np.testing.assert_allclose(res_sh.points.numpy(), np.asarray(jres.points), atol=1e-3)
    assert res_sh.points.shape == (100, 3)


def _adjust_args(seed):
    problem = make_ba_problem(seed, n_frames=4, n_points=64, n_obs=256)
    ext = jproj.extrinsics_from_params(problem.cam_params)
    jax_args = (ext, problem.intrinsics, problem.points, problem.obs, problem.frame_idx, problem.point_idx)
    torch_args = tuple(torch.from_numpy(np.array(a)) for a in jax_args[:4]) + tuple(
        torch.from_numpy(np.asarray(a, np.int64)) for a in jax_args[4:]
    )
    return jax_args, torch_args


@pytest.fixture
def shard_spies(monkeypatch):
    """Record the data-axis size of every point-sharded solve of either
    package (and let it run)."""
    calls = {"jax": [], "torch": []}
    real_j, real_t = jsharded.solve_ba_point_sharded, sharded.solve_ba_point_sharded

    def spy(key, real):
        def call(mesh, *args, **kwargs):
            calls[key].append(mesh.shape["data"])
            return real(mesh, *args, **kwargs)

        return call

    monkeypatch.setattr(jsharded, "solve_ba_point_sharded", spy("jax", real_j))
    monkeypatch.setattr(sharded, "solve_ba_point_sharded", spy("torch", real_t))
    return calls


def test_adjust_points_opt_in(shard_spies):
    jax_args, args = _adjust_args(11)
    cfg = JaxSolverConfig(point_shard_devices=8)
    pts_sh, _, res_sh = tba.adjust_points(*args, config=from_fields(cfg), devices=cpus(8))
    pts_1, _, res_1 = tba.adjust_points(*args)
    _, _, jres = jba.adjust_points(*jax_args)
    assert shard_spies["torch"] == [8]
    np.testing.assert_allclose(float(res_sh.rmse), float(res_1.rmse), rtol=1e-4)
    np.testing.assert_allclose(pts_sh.numpy(), pts_1.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(res_sh.rmse), float(jres.rmse), rtol=1e-4)
    # Fewer devices than asked for: the solve takes what there is.
    tba.adjust_points(*args, config=from_fields(cfg), devices=cpus(2))
    assert shard_spies["torch"] == [8, 2]


def test_band_shards_on_padded_sizes(shard_spies):
    """64 points x 4 frames pad to the bucket's 256 x 4: a strip of 147 456 B
    against a 100 000 B budget needs 2 shards in both packages (the exact
    sizes would give 36 864 B, one device)."""
    jax_args, args = _adjust_args(11)
    cfg = JaxSolverConfig(hbm_strip_budget_bytes=100_000)
    jpts, _, jres = jba.adjust_points(*jax_args, config=cfg)
    pts, _, res = tba.adjust_points(*args, config=from_fields(cfg), devices=cpus(8))
    assert shard_spies["jax"] == shard_spies["torch"] == [2]
    _, _, res_1 = tba.adjust_points(*args)
    np.testing.assert_allclose(float(res.rmse), float(res_1.rmse), rtol=1e-4)
    np.testing.assert_allclose(float(res.rmse), float(jres.rmse), rtol=1e-4)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=5e-3)


def test_band_refuses_oversized_problem_before_allocating():
    """100k points x 100 cameras at a 64 MiB budget needs 23 shards, more
    than 8 devices: both packages raise the band's text."""
    f, p = 100, 100_000
    jext = jproj.extrinsics_from_params(jnp.zeros((f, 6), jnp.float32))
    cfg = JaxSolverConfig(hbm_strip_budget_bytes=64 * 2**20)
    with pytest.raises(ValueError, match="memory band") as jerr:
        jba.adjust_points(
            jext, jnp.eye(3, dtype=jnp.float32), jnp.zeros((p, 3), jnp.float32), jnp.zeros((8, 2), jnp.float32),
            jnp.zeros(8, jnp.int32), jnp.zeros(8, jnp.int32), config=cfg,
        )
    with pytest.raises(ValueError, match="memory band") as terr:
        tba.adjust_points(
            torch.from_numpy(np.array(jext)), torch.eye(3), torch.zeros((p, 3)), torch.zeros((8, 2)),
            torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64), config=from_fields(cfg),
            devices=cpus(8),
        )
    assert str(terr.value) == str(jerr.value)


def test_disabled_band_keeps_one_device(shard_spies):
    _, args = _adjust_args(12)
    _, _, res = tba.adjust_points(*args, config=from_fields(JaxSolverConfig(hbm_strip_budget_bytes=0)), devices=cpus(8))
    assert np.isfinite(float(res.rmse)) and shard_spies["torch"] == []


def test_solve_ba_batch_ignores_point_sharding(eight_problems):
    """The JAX batch solve is ``vmap(solve_ba)``, which reads neither
    ``point_shard_devices`` nor the band: neither changes the port's."""
    batched = to_torch(jax.tree.map(lambda *xs: jnp.stack(xs), *eight_problems[:3]))
    cfg = from_fields(JaxSolverConfig(point_shard_devices=2, hbm_strip_budget_bytes=1024))
    res = tba.solve_ba_batch(batched, config=cfg)
    ref = tba.solve_ba_batch(batched)
    np.testing.assert_array_equal(res.rmse.numpy(), ref.rmse.numpy())
    np.testing.assert_array_equal(res.iterations.numpy(), ref.iterations.numpy())


def test_match_descriptors_tp_over_model():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 2, size=(96, 256)).astype(np.int8)
    t = rng.integers(0, 2, size=(128, 256)).astype(np.int8)
    t[32:64] = q[:32]  # strong matches
    t[100] = t[33]  # a tie across members: the lower index wins
    qm = np.ones(96, bool)
    tm = np.ones(128, bool)
    tm[5] = False
    mesh = sharded.make_mesh(data=1, model=8, devices=cpus(8))
    idx, dist, good = sharded.match_descriptors_tp(
        mesh, torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(qm), torch.from_numpy(tm)
    )
    ref = jmatching.match_descriptors(q, t, qm, tm, cross_check=False, max_matches=96)
    ref_idx = np.full(96, -1)
    ref_good = np.zeros(96, bool)
    mk = np.asarray(ref.mask)
    ref_idx[np.asarray(ref.query_idx)[mk]] = np.asarray(ref.train_idx)[mk]
    ref_good[np.asarray(ref.query_idx)[mk]] = True
    good = good.numpy()
    assert good.sum() >= 30
    np.testing.assert_array_equal(good, ref_good)
    np.testing.assert_array_equal(idx.numpy()[good], ref_idx[good])
    # The port's one-device matcher gives the same best distances.
    one = tmatching.match_descriptors(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(qm), torch.from_numpy(tm), cross_check=False
    )
    np.testing.assert_array_equal(dist.numpy()[one.query_idx[one.mask].numpy()], one.distance[one.mask].numpy())


def test_preprocess_sharded_over_data():
    frames = render_sequence(TINY_SCENE, 8, seed=2)[0]
    out = sharded.preprocess_sharded(sharded.make_mesh(data=8, devices=cpus(8)), frames)
    assert out.shape == (8, 120, 160) and out.dtype == torch.float32
    assert torch.equal(out, tclahe.enhanced_grey(torch.from_numpy(frames)))
    diff = np.abs(out.numpy() - np.asarray(jclahe.enhanced_grey(jnp.asarray(frames))))
    assert np.mean(diff <= 1e-3) >= 0.9999 and diff.max() <= 8.0
    with pytest.raises(ValueError, match="do not split"):
        sharded.preprocess_sharded(sharded.make_mesh(data=3, devices=cpus(3)), frames)


def test_cli_mesh_schedule_sizes_the_mesh(monkeypatch, tmp_path):
    """``--schedule mesh``: on the CPU one device (no mesh); with CUDA a
    data axis of min(GPUs, videos), none on one GPU (the JAX CLI's rule)."""
    seen = []

    def fake_batch(videos, mesh=None, **kwargs):
        seen.append(mesh)
        raise SystemExit(0)

    monkeypatch.setattr(tbatch, "process_batch", fake_batch)
    for i in range(3):
        np.save(tmp_path / f"v{i}.npy", np.zeros((2, 8, 8, 3), np.uint8))
    videos = [str(tmp_path / f"v{i}.npy") for i in range(3)]
    argv = [*videos, "--schedule", "mesh", "--detector", "device"]
    with pytest.raises(SystemExit), contextlib.redirect_stdout(io.StringIO()):
        cli.main([*argv, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for gpus, want in ((8, 3), (2, 2), (1, None)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda g=gpus: g)
        with pytest.raises(SystemExit):
            cli.main(argv)
        want_devices = None if want is None else tuple((torch.device("cuda", i),) for i in range(want))
        assert (seen[-1] and seen[-1].devices) == want_devices
    assert seen[0] is None
