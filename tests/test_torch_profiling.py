"""The port's spans and counters (``utils/profiling``): paths composed from
the per-thread stack of open spans, timings keyed by path, the host-read
counters fed by CUDA's sync debug warnings under
``MEATMODELER_SYNC_STAGES`` (a synthetic warning stands in for the card's
here), the LM loops' iteration counters, and ``chain_poses``'s stages on
the profiler's clock and in ``OdometryResult.metrics``."""

import json
import threading
import warnings

import pytest
import torch

from meatmodeler_tpu_torch.geometry import projection
from meatmodeler_tpu_torch.io.synthetic import TurntableScene, render_sequence
from meatmodeler_tpu_torch.odometry import chain_poses
from meatmodeler_tpu_torch.parallel import sharded
from meatmodeler_tpu_torch.solvers import bundle_adjust
from meatmodeler_tpu_torch.tools.profile_headline import synthetic_ba_problem
from meatmodeler_tpu_torch.utils import profiling
from meatmodeler_tpu_torch.utils.profiling import SYNC_WARNING, Metrics, span_add, span_path, trace

torch.set_num_threads(2)

ODOMETRY_STAGES = {
    "odometry_enhance", "odometry_pyramid", "odometry_lk", "odometry_relpose", "odometry_scale", "odometry_reseed",
}


@pytest.fixture
def synced(monkeypatch):
    monkeypatch.setenv("MEATMODELER_SYNC_STAGES", "1")


@pytest.fixture
def unsynced(monkeypatch):
    monkeypatch.delenv("MEATMODELER_SYNC_STAGES", raising=False)


def test_paths_nest_and_time_by_path(unsynced):
    metrics = Metrics()
    assert span_path() is None
    with metrics.stage("pass1_keyframes"):
        assert span_path() == "pass1_keyframes"
        with trace("scan"):
            with trace("lk"):
                assert span_path() == "pass1_keyframes/scan/lk"
            assert span_path() == "pass1_keyframes/scan"
        with trace("scan"):  # a second entry adds to the same path
            pass
    assert span_path() is None
    t = metrics.timings
    assert set(t) == {"pass1_keyframes", "pass1_keyframes/scan", "pass1_keyframes/scan/lk"}
    assert 0.0 <= t["pass1_keyframes/scan/lk"] <= t["pass1_keyframes/scan"] <= t["pass1_keyframes"]
    # A stage nested in another stage of the same Metrics is its child.
    with metrics.stage("a"):
        with metrics.stage("b"):
            assert span_path() == "a/b"
    assert "a/b" in metrics.timings and "b" not in metrics.timings


def test_span_without_metrics_times_nothing(unsynced):
    metrics = Metrics()
    with trace("describe"):
        with trace("lanes"):
            assert span_path() == "describe/lanes"
            span_add("lm_iterations", 3)  # no Metrics open: dropped
        # A stage inside a plain span starts its own path.
        with metrics.stage("pass2_orb"):
            assert span_path() == "pass2_orb"
            with trace("detect"):
                assert span_path() == "pass2_orb/detect"
    assert set(metrics.timings) == {"pass2_orb", "pass2_orb/detect"} and metrics.counters == {}


def test_stage_of_another_metrics_starts_its_own_path(unsynced):
    outer, inner = Metrics(), Metrics()
    with outer.stage("batch"):
        with inner.stage("bundle_adjustment"):
            with trace("decide"):
                assert span_path() == "bundle_adjustment/decide"
                span_add("lm_iterations", 2)
        with trace("solve"):
            span_add("lm_iterations", 5)
    assert set(inner.timings) == {"bundle_adjustment", "bundle_adjustment/decide"}
    assert inner.counters == {"lm_iterations:bundle_adjustment/decide": 2}
    assert set(outer.timings) == {"batch", "batch/solve"}
    assert outer.counters == {"lm_iterations:batch/solve": 5}


def test_stacks_are_per_thread(unsynced):
    """Two threads open spans in lockstep, each inside its own stage of one
    shared Metrics: each sees its own path, and the timings keep both."""
    metrics = Metrics()
    barrier = threading.Barrier(2)
    seen = {}

    def work(name):
        with metrics.stage(name):
            barrier.wait()
            with trace("child"):
                barrier.wait()
                seen[name] = span_path()
                span_add("lm_iterations", 1)
                barrier.wait()
        seen[name + ".after"] = span_path()

    threads = [threading.Thread(target=work, args=(n,)) for n in ("pass2_orb", "pose_ba")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"pass2_orb": "pass2_orb/child", "pose_ba": "pose_ba/child",
                    "pass2_orb.after": None, "pose_ba.after": None}
    assert set(metrics.timings) == {"pass2_orb", "pass2_orb/child", "pose_ba", "pose_ba/child"}
    assert metrics.counters == {"lm_iterations:pass2_orb/child": 1, "lm_iterations:pose_ba/child": 1}


def _sync_warning():
    warnings.warn(SYNC_WARNING)


def test_sync_warnings_count_in_the_innermost_span(synced, monkeypatch):
    """Under ``MEATMODELER_SYNC_STAGES`` every synchronizing warning of a
    stage counts once in its innermost span (a line warning twice counts
    twice); the exit barrier's do not; none is shown, other warnings are;
    the caller's ``showwarning`` and filters come back after the stage."""
    monkeypatch.setattr(profiling, "device_barrier", _sync_warning)
    show, filters = warnings.showwarning, list(warnings.filters)
    metrics = Metrics()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with metrics.stage("pose_ba"):
            _sync_warning()
            with trace("decide"):
                for _ in range(3):
                    _sync_warning()
                warnings.warn("something else")
            with trace("solve"):
                pass
        _sync_warning()  # no stage open: the caller sees it
    assert metrics.counters == {"host_reads:pose_ba": 1, "host_reads:pose_ba/decide": 3}
    assert [str(w.message) for w in caught] == ["something else", SYNC_WARNING]
    assert warnings.showwarning is show and warnings.filters == filters


def test_nothing_is_hooked_without_the_variable(unsynced):
    show = warnings.showwarning
    metrics = Metrics()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        caught_show = warnings.showwarning
        with metrics.stage("pose_ba"):
            assert warnings.showwarning is caught_show
            with trace("decide"):
                _sync_warning()
    assert metrics.counters == {}
    assert [str(w.message) for w in caught] == [SYNC_WARNING]
    assert warnings.showwarning is show


def test_hook_is_held_while_any_thread_has_a_stage_open(synced):
    """The hook goes when the last open stage of any thread closes, and each
    thread's warnings count in its own span."""
    show = warnings.showwarning
    metrics = Metrics()
    opened, closed = threading.Event(), threading.Event()

    def other():
        with metrics.stage("pass2_orb"):
            opened.set()
            closed.wait()
            _sync_warning()

    t = threading.Thread(target=other)
    t.start()
    opened.wait()
    with metrics.stage("pose_ba"):
        _sync_warning()
    assert warnings.showwarning is not show  # the other thread still holds it
    closed.set()
    t.join()
    assert warnings.showwarning is show
    assert metrics.counters == {"host_reads:pose_ba": 1, "host_reads:pass2_orb": 1}


def _pose_chain(problem):
    """Three pose-only problems against 50 fixed points, from the problem's
    perturbed cameras (``pose_only_refine`` returns no iteration count)."""
    pts = problem.points[:50]
    obs = torch.stack([projection.project_points(pts, c.expand(50, 6), problem.intrinsics)
                       for c in problem.cam_params[:3]])
    bundle_adjust.pose_only_refine(problem.cam_params[:3] + 0.01, pts.expand(3, -1, -1), problem.intrinsics, obs,
                                   torch.ones(3, 50, dtype=torch.bool))


def _two_lanes(problem):
    return bundle_adjust.BAProblem(*(None if x is None else torch.stack([x, x]) for x in problem))


def _two_cpus():
    return sharded.make_mesh(data=2, devices=["cpu"] * 2)


# Each LM entry point, run in a stage of its name; returns the iterations it reports.
LM_SOLVES = {
    "bundle_adjustment": lambda p: bundle_adjust.solve_ba(p).iterations,
    "pose_ba": lambda p: bundle_adjust.solve_ba(p, fix_points=True).iterations,
    "pose_chain": _pose_chain,
    "batch_solve": lambda p: int(bundle_adjust.solve_ba_batch(_two_lanes(p)).iterations.max()),
    "point_sharded": lambda p: sharded.solve_ba_point_sharded(_two_cpus(), p).iterations,
    "mesh_batch": lambda p: int(sharded.solve_ba_batch(_two_cpus(), _two_lanes(p)).iterations.max()),
}


@pytest.mark.parametrize("stage", list(LM_SOLVES))
def test_lm_loops_count_their_iterations(unsynced, stage):
    """Every LM solve adds its iterations (the largest lane's) to
    ``lm_iterations:<path>`` once, and times its ``linearize``, ``solve``
    and ``decide`` children."""
    problem = synthetic_ba_problem("cpu", n_frames=4, n_points=60, n_obs=400)
    metrics = Metrics()
    with metrics.stage(stage):
        iterations = LM_SOLVES[stage](problem)
    counted = {k: v for k, v in metrics.counters.items() if k.startswith("lm_iterations:")}
    assert list(counted) == [f"lm_iterations:{stage}"]
    n = counted[f"lm_iterations:{stage}"]
    assert n >= 1 and (iterations is None or n == iterations)
    assert {f"{stage}/linearize", f"{stage}/solve", f"{stage}/decide"} <= set(metrics.timings)


@pytest.fixture(scope="module")
def odometry_clip():
    scene = TurntableScene(image_size=(400, 300), focal=420.0, noise_sigma=0.5)
    frames, _, _ = render_sequence(scene, 3, seed=3)
    return frames, scene.intrinsics


def test_chain_poses_stages_on_the_profiler(odometry_clip, unsynced):
    frames, k = odometry_clip
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = chain_poses(frames, k, generator=torch.Generator().manual_seed(0), device="cpu")
    names = {e.name for e in prof.events()}
    assert ODOMETRY_STAGES <= names
    assert set(res.metrics) == {"timings", "counters"}
    # The stages and the scale step's child span: the chain's one read.
    assert set(res.metrics["timings"]) == ODOMETRY_STAGES | {"odometry_scale/result"}
    assert all(v > 0.0 for v in res.metrics["timings"].values())
    assert res.metrics is res[-1] and len(res.poses) == len(frames)


def test_profile_run_traces_chain_poses(odometry_clip, unsynced, monkeypatch, tmp_path):
    """``MEATMODELER_PROFILE=<dir>`` writes a chrome trace of a
    ``chain_poses`` call with its stages in it."""
    frames, k = odometry_clip
    monkeypatch.setenv("MEATMODELER_PROFILE", str(tmp_path))
    chain_poses(frames[:2], k, generator=torch.Generator().manual_seed(0), device="cpu")
    [path] = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {ev.get("name") for ev in events if ev.get("cat") == "user_annotation"}
    assert {"odometry_enhance", "odometry_lk", "odometry_relpose", "odometry_scale"} <= names
    # A profiler already running is left alone: no second trace.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.profile_run():
            torch.ones(2).sum()
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
