"""The readers of the program's nested spans and host-read counters
(``portbench/spans.py``, ``metrics/idle_s.*``, ``metrics/host_reads.*``) on
synthetic windows: a program with nested spans, and one without (the gaps
under the top-level stages, no host reads, the odometry's under the call)."""

import pytest

from portbench import spans, spec

NESTED_TRACE = {
    "calls": 2, "busy_s": 0.1, "window_s": 4.0, "launches": 10, "kernel_s": {},
    "idle_s": {
        "pass1_keyframes": 0.2, "pass1_keyframes/scan": 1.0, "pass1_keyframes/flags_read": 0.4,
        "board_detect": 0.3, "pass2_orb/describe": 0.6, "pass2_tracks": 0.1, "pose_ba/decide": 0.25,
        "calibration": 0.05, "bundle_adjustment/solve": 0.3, "triangulation/observations": 0.1,
        "portbench.call": 0.02, "outside": 0.01, "odometry_lk": 0.5, "odometry_enhance": 0.1,
        "odometry_relpose": 0.8, "odometry_scale": 0.3, "odometry_reseed": 0.04,
    },
}
ROWS = [
    {"timings": {}, "counters": {"host_reads:pass1_keyframes/flags_read": 10, "host_reads:pose_ba/decide": 20,
                                 "host_reads:bundle_adjustment/decide": 7, "host_reads:result": 9,
                                 "lm_iterations:pose_ba": 20}},
    {"timings": {}, "counters": {"host_reads:pass1_keyframes/flags_read": 12, "host_reads:pose_ba/decide": 18,
                                 "host_reads:pose_ba/solve": 4, "host_reads:triangulation/observations": 5}},
]


def _readers(cell):
    c = spec.resolve(cell)
    return {m["name"]: spec.metric_module(c, m["name"]).read for m in c.per_layer}


def test_head_of_a_path():
    assert spans.head("pose_ba/decide") == "pose_ba" and spans.head("volume") == "volume"


def test_idle_by_layer_per_call():
    ctx = {"trace": NESTED_TRACE, "rows": ROWS, "recorded": {}}
    board = _readers("board_video_1080p")
    assert board["idle_s.pass1"](ctx) == pytest.approx((0.2 + 1.0 + 0.4) / 2)
    assert board["idle_s.board_detect"](ctx) == pytest.approx(0.15)
    assert board["idle_s.pass2"](ctx) == pytest.approx((0.6 + 0.1) / 2)
    assert board["idle_s.board_geometry"](ctx) == pytest.approx((0.25 + 0.05) / 2)
    assert board["idle_s.solve"](ctx) == pytest.approx((0.3 + 0.1) / 2)
    odo = _readers("odometry_720p")
    assert odo["idle_s.track"](ctx) == pytest.approx((0.5 + 0.1) / 2)
    assert odo["idle_s.relpose"](ctx) == pytest.approx(0.4)
    assert odo["idle_s.chain"](ctx) == pytest.approx((0.3 + 0.04) / 2)
    assert "idle_s.board_detect" not in _readers("board_known_1080p")
    assert not {"idle_s.pass1", "host_reads.pass1"} & set(odo)


def test_host_reads_by_layer_per_call():
    ctx = {"trace": NESTED_TRACE, "rows": ROWS, "recorded": {}}
    board = _readers("board_video_1080p")
    assert board["host_reads.pass1"](ctx) == pytest.approx(11.0)
    assert board["host_reads.board_geometry"](ctx) == pytest.approx((20 + 22) / 2)
    assert board["host_reads.solve"](ctx) == pytest.approx((7 + 5) / 2)
    # A layer without reads in a program that counts them reads 0.
    assert board["host_reads.board_detect"](ctx) == 0.0 and board["host_reads.pass2"](ctx) == 0.0
    # Calls that count no host read at all (a program without the counters)
    # are left out of the mean.
    ctx["rows"] = ROWS + [{"timings": {}, "counters": {"ba_iterations": 7}}]
    assert board["host_reads.pass1"](ctx) == pytest.approx(11.0)


def test_a_program_without_nested_spans():
    """The parent's windows: the board gaps under the top-level stages read
    the same; the odometry's gaps under the call read nothing; no host-read
    counters, no host-read metric."""
    trace = dict(NESTED_TRACE, idle_s={"pass1_keyframes": 1.6, "pass2_orb": 0.6, "portbench.call": 3.2,
                                       "outside": 0.001})
    rows = [{"timings": {"pass1_keyframes": 0.7}, "counters": {"ba_iterations": 7}}]
    ctx = {"trace": trace, "rows": rows, "recorded": {}}
    board = _readers("board_known_1080p")
    assert board["idle_s.pass1"](ctx) == pytest.approx(0.8)
    assert board["idle_s.pass2"](ctx) == pytest.approx(0.3)
    assert board["idle_s.solve"](ctx) is None
    assert all(board[f"host_reads.{layer}"](ctx) is None
               for layer in ("pass1", "pass2", "board_geometry", "solve"))
    odo = _readers("odometry_720p")
    assert all(odo[f"idle_s.{layer}"](ctx) is None for layer in ("track", "relpose", "chain"))
