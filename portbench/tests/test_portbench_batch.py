"""The batched cell (``entries/process_batch.py``) at a tiny size on the CPU:
three 400x300 clips of 40 frames through ``process_batch`` with the device
board detector, in a benchmark root of its own. A run prints the contract's
keys and is correct, with the batch's per-layer readers reading the
program's spans and counters; each fault planted under the timed path reads
``correct`` false; the control reads above every limit."""

import json

import pytest
import torch

from portbench import control, run, spec
from portbench.tests.tiny import tiny_pipeline, tiny_root

LAST_LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
READERS = ("stage_s.batch_prepass", "stage_s.batch_pool", "stage_s.batch_solve", "ba_lane_occupancy")


@pytest.fixture(scope="module")
def tiny_batch(tmp_path_factory):
    """``tiny_batch``: one batch of three clips a run, one call checked."""
    root = tiny_root(tmp_path_factory.mktemp("tiny_batch"), checks=1)
    pb = root / "portbench"
    pipeline = tiny_pipeline()
    pipeline["chessboard"]["detector"] = "device"
    board = json.loads((pb / "configs" / "tiny_board.json").read_text())
    (pb / "configs" / "tiny_batch.json").write_text(json.dumps(dict(board, name="tiny_batch", videos=3,
                                                                    pipeline=pipeline)))
    (pb / "traffic" / "tiny_batch.json").write_text(json.dumps(dict(
        json.loads((spec.REPO / "portbench" / "traffic" / "batch_hunt.json").read_text()), batches=1, checks=1)))
    (pb / "checks" / "tiny_batch.json").write_text((pb / "checks" / "board_batch8_1080p.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_batch", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny_batch.json", "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny_batch", "config": "tiny_batch", "traffic": "tiny_batch", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "board_batch8_1080p" in m.get("workloads", ()):
            m["workloads"].append("tiny_batch")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.resolve("tiny_batch", root)


def test_the_cell_resolves(tiny_batch):
    assert [m["name"] for m in tiny_batch.end_to_end] == ["fps", "setup_s"]
    assert {m["name"] for m in tiny_batch.per_layer} == set(READERS) | {
        "idle_s.batch_pool", "idle_s.batch_solve", "roofline_pct.ba_jac"}
    assert tiny_batch.traffic["entry"] == "process_batch" and tiny_batch.config["videos"] == 3


def test_a_run_prints_the_contracts_keys(tiny_batch):
    torch.set_num_threads(4)
    res = run.measure(tiny_batch, 2**31 + 11, 0.0, False, "cpu")
    assert list(res) == LAST_LINE_KEYS
    assert res["correct"] and res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"fps", "setup_s"} and all(m["value"] > 0 for m in res["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_the_batch_readers_read_the_programs_spans(tiny_batch):
    """One call's batch-level timings and counters, as the synced window
    hands them to the readers."""
    runner = spec.entry_module(tiny_batch).Runner(tiny_batch.config, tiny_batch.traffic, "cpu")
    try:
        batch = runner.inputs(5)[0]
        rec = runner.run(batch)
        rows = runner.layer_rows([runner.summarize(rec)])
        iters = [r.metrics["counters"]["ba_iterations"] for r in rec.results]
        assert [len(lane) for lane in rec.lanes] and all("preba" in lane for lane in rec.lanes)
    finally:
        runner.close()
    assert runner.frames(batch) == 120
    ctx = {"rows": rows, "trace": {}, "recorded": {}}
    values = {name: spec.metric_module(tiny_batch, name).read(ctx) for name in READERS}
    assert all(values[name] > 0 for name in READERS[:3])
    assert values["ba_lane_occupancy"] == pytest.approx(100.0 * sum(iters) / (3 * max(iters)))


def _swapped_results(monkeypatch):
    """Two videos' results swapped after the solve."""
    from meatmodeler_tpu_torch.parallel import batch

    real = batch._solve_and_finish_batch

    def solve_and_finish(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0], out[1] = out[1], out[0]
        return out

    monkeypatch.setattr(batch, "_solve_and_finish_batch", solve_and_finish)


def _first_lane_solved_before(monkeypatch):
    """The batched LM's first lane starts at its own solution, so that it
    stops at its first iteration while the others run on (harmless
    alone)."""
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    real = bundle_adjust.solve_ba_batch

    def solve_ba_batch(problem, config):
        first = real(bundle_adjust.BAProblem(*(x[:1] for x in problem)), config=config)
        return real(problem._replace(cam_params=torch.cat([first.cam_params, problem.cam_params[1:]]),
                                     points=torch.cat([first.points, problem.points[1:]])), config=config)

    monkeypatch.setattr(bundle_adjust, "solve_ba_batch", solve_ba_batch)


def _lanes_stop_together(monkeypatch):
    """The batched LM stops every lane when the first stops. (On the tiny
    batch alone the lanes stop at 18, 6 and 10 iterations, and stopped
    together at 6 each lane is already at float32's rounding floor: the
    check rightly reads it correct. So the first lane is made to stop at
    once, ``_first_lane_solved_before``, and the others stop with it.)"""
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    _first_lane_solved_before(monkeypatch)
    real = bundle_adjust._BatchSolve.step

    def step(self):
        real(self)
        self.active = self.active & self.active.all()
        return self.active.any()

    monkeypatch.setattr(bundle_adjust._BatchSolve, "step", step)


def _padding_unmasked(monkeypatch):
    """The padded observations are left in the batched problem's mask."""
    from meatmodeler_tpu_torch.solvers import bundle_adjust

    real = bundle_adjust.solve_ba_batch

    def solve_ba_batch(problem, *args, **kwargs):
        assert not problem.mask.all()  # the fault has padding to unmask
        return real(problem._replace(mask=torch.ones_like(problem.mask)), *args, **kwargs)

    monkeypatch.setattr(bundle_adjust, "solve_ba_batch", solve_ba_batch)


@pytest.mark.parametrize("fault,caught_by", [
    (_swapped_results, "ba_gain"), (_lanes_stop_together, "ba_gain"), (_padding_unmasked, "rmse_gap"),
])
def test_a_fault_under_the_timed_path_is_not_correct(tiny_batch, monkeypatch, fault, caught_by):
    torch.set_num_threads(4)
    fault(monkeypatch)
    res = run.measure(tiny_batch, 5, 0.0, False, "cpu")
    assert not res["correct"] and res["failed"] == 1
    assert res["checks"][caught_by]["value"] > res["checks"][caught_by]["limit"]


def test_a_lane_that_stops_first_alone_is_correct(tiny_batch, monkeypatch):
    """The set-up of the lanes-stop-together fault without the fault: the
    first lane stops at once, the others run to their own stop."""
    torch.set_num_threads(4)
    _first_lane_solved_before(monkeypatch)
    res = run.measure(tiny_batch, 5, 0.0, False, "cpu")
    assert res["correct"] and res["failed"] == 0


def test_the_control_reads_above_the_limits(tiny_batch):
    """The program's worst reading over the videos under each limit, the
    control's smallest above it."""
    torch.set_num_threads(4)
    out = control.readings(tiny_batch, [7], {7}, 1, "cpu")
    for name, limit in tiny_batch.limits.items():
        assert out["lower"][name] <= limit < out["upper"][name], name
