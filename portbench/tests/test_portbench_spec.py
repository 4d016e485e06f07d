"""BENCHMARK.json against the benchmark's contract, and every cell and
metric resolved to its files by name; a cell and a metric added as files
alone are picked up."""

import json
import math

import pytest

from portbench import spec
from portbench.tests.tiny import tiny_root

BENCH = spec.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"] and len(BENCH["command"]) <= 32
    assert all(_one_line(word) for word in BENCH["command"])
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(spec.NAME.match(n) for n in names), [n for n in names if not spec.NAME.match(n)]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in metrics:
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and _one_line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"} and _one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(workload):
    cell = spec.resolve(workload)
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "fps"} <= names and cell.per_layer
    assert cell.config["reduced"] == next(c["reduced"] for c in BENCH["configs"] if c["name"] == cell.workload["config"])
    assert hasattr(spec.entry_module(cell), "Runner")
    assert cell.limits and all(math.isfinite(v) and v > 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(spec.metric_module(cell, m["name"]).read)
        assert m["moves"] in names


def test_added_files_are_picked_up(tmp_path):
    """A new cell (configuration, traffic and limits files and its
    BENCHMARK.json entry) and a new metric (its reader file and entry) need
    no edit of an existing file."""
    root = tiny_root(tmp_path)
    (root / "portbench" / "metrics" / "dummy.frames.py").write_text("def read(ctx):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "dummy.frames", "unit": "frames", "better": "higher", "source": "program_counter",
                               "layer": "pass 1", "moves": "fps", "workloads": ["tiny_known"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("tiny_known", root)
    assert cell.config["frames"] == 40 and cell.traffic["entry"] == "process"
    assert "dummy.frames" in [m["name"] for m in cell.per_layer]
    assert spec.metric_module(cell, "dummy.frames").read({}) == 42.0
    assert "dummy.frames" not in [m["name"] for m in spec.resolve("board_known_1080p", root).per_layer]
