"""The harness's arithmetic without a card: the rate over a window with a
stalled call, the closed loop, the idle and roofline shares from a
synthetic trace."""

import random
import time

import pytest

from portbench import readers, run, trace
from portbench.frozen import work


def test_rate_counts_a_stalled_call_to_its_end():
    # Three 1 s calls of 100 frames, then one that stalls for 7 s past a
    # 4 s window: it runs to its end and counts, and so does its time.
    calls = [(0.0, 1.0, 100, True), (1.0, 2.0, 100, True), (2.0, 3.0, 100, True), (3.0, 10.0, 100, True)]
    assert run.rate(calls) == pytest.approx(400 / 10.0)
    # A failed call's frames do not count; its time does.
    calls[1] = (1.0, 2.0, 100, False)
    assert run.rate(calls) == pytest.approx(300 / 10.0)
    assert run.rate([]) == 0.0


class _Runner:
    """Calls that take ``durations`` seconds in turn; ``fail`` raises."""

    def __init__(self, durations, fail=()):
        self.durations, self.fail, self.n = durations, set(fail), 0

    def frames(self, clip):
        return 10

    def run(self, clip):
        i, self.n = self.n, self.n + 1
        time.sleep(self.durations[i % len(self.durations)])
        if i in self.fail:
            raise RuntimeError("boom")
        return _Rec(i)

    def summarize(self, rec):
        return rec.i


class _Rec:
    def __init__(self, i):
        self.i, self.released = i, False

    def release(self):
        self.released = True


def test_window_runs_the_last_call_to_its_end_and_samples_from_the_seed():
    runner = _Runner([0.01, 0.01, 0.2], fail=(1,))
    summaries, calls, cpu, kept, errors = run.window(runner, ["a", "b"], 0.05, 2, random.Random(7))
    assert len(calls) == 3 and len(cpu) == 3 and len(errors) == 1 and summaries == [0, 2]
    assert calls[-1][1] - calls[-1][0] >= 0.2  # the stalled call ran to its end
    assert not calls[1][3] and calls[0][3] and calls[2][3]
    assert [rec.i for _, rec in kept] == [0, 2]
    summaries, _, _, again, _ = run.window(_Runner([0.001]), ["a"], 0.05, 3, random.Random(7))
    assert len(again) == 3 and all(not rec.released for _, rec in again)
    # Every call is summarised; only the sampled ones keep their records.
    assert len(summaries) > 3 and sorted(rec.i for _, rec in again) == sorted({i for i, _ in again})


def test_host_state_reads_what_it_can():
    state = run.host_state()
    assert state["cores_allowed"] >= 1 and state["load_1min"] >= 0


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_and_roofline_from_a_synthetic_trace():
    events = [
        _event("user_annotation", "portbench.call", 0.0, 1000.0),
        _event("user_annotation", "pass1_keyframes", 0.0, 500.0),
        _event("kernel", "clahe_lut_kernel(float const*, float*)", 100.0, 50.0),
        _event("kernel", "clahe_apply_kernel(float const*)", 120.0, 80.0),  # overlaps the first
        _event("gpu_memcpy", "Memcpy HtoD", 600.0, 100.0),
        _event("cpu_op", "aten::add", 0.0, 900.0),
    ]
    s = trace.summarize(events, window_s=1000e-6)
    assert s["busy_s"] == pytest.approx(200e-6) and s["launches"] == 2
    # Gaps: [0, 100) and [200, 500) under pass1_keyframes; [500, 600) and
    # [700, 1000) under the call's own range.
    assert s["idle_s"] == pytest.approx({"pass1_keyframes": 400e-6, "portbench.call": 400e-6})
    ctx = {"trace": dict(s, calls=1), "rows": [], "recorded": {}}
    assert readers.kernel_seconds(ctx, ("clahe_lut_kernel", "clahe_apply_kernel")) == pytest.approx(130e-6)
    nbytes = work.clahe_lut_bytes((2, 64, 64)) + work.clahe_apply_bytes((2, 64, 64))
    assert readers.roofline_pct(ctx, ("clahe_",), [(0, nbytes)]) == pytest.approx(
        100 * nbytes / work.HBM_BYTES_PER_S / 130e-6)
    assert readers.roofline_pct(ctx, ("refine_relpose_kernel",), [(1, 1)]) is None
    assert readers.roofline_pct(ctx, ("clahe_",), []) is None


def test_the_device_readers(tmp_path):
    from portbench import spec

    cell = spec.resolve("board_known_1080p")
    ctx = {"trace": {"busy_s": 0.25, "window_s": 1.0, "launches": 300, "calls": 2, "kernel_s": {}, "idle_s": {}},
           "rows": [{"timings": {"pass1_keyframes": 0.5, "pass2_orb": 0.25}, "counters": {"ba_iterations": 7}},
                    {"timings": {"pass1_keyframes": 0.7}, "counters": {"ba_iterations": 9}}],
           "recorded": {}}
    read = {m["name"]: spec.metric_module(cell, m["name"]).read for m in cell.per_layer}
    assert read["device_idle_pct"](ctx) == pytest.approx(75.0)
    assert read["launches_per_video"](ctx) == 150
    assert read["stage_s.pass1"](ctx) == pytest.approx(0.6)
    assert read["stage_s.orb"](ctx) == pytest.approx(0.25)  # over the calls that ran it
    assert read["ba_iterations"](ctx) == 8
    assert read["stage_s.volume"](ctx) is None
    assert read["roofline_pct.clahe"](ctx) is None  # nothing traced: no share, never 0


def test_recording_keeps_the_arguments_with_defaults_and_puts_the_function_back():
    real = work.clahe_lut_bytes
    with trace.recording(["portbench.frozen.work:clahe_lut_bytes"]) as calls:
        assert work.clahe_lut_bytes((1, 8, 8)) == real((1, 8, 8))
        work.clahe_lut_bytes((2, 8, 8), tiles=(4, 4))
    assert work.clahe_lut_bytes is real
    assert calls["clahe_lut_bytes"] == [((1, 8, 8), (8, 8)), ((2, 8, 8), (4, 4))]
