"""The benchmark's definition: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, entry point,
cell or per-layer metric is a file of its own, found by its name:

- ``configs[].file``: the configuration (scene, clip length, the program's
  configuration as data, ``source``, ``assumed``, ``reduced``);
- ``portbench/traffic/<traffic>.json``: the traffic mix (the entry point it
  drives, what the client sends, clips per run, how their seeds follow from
  ``--seed``, the program options the mix sets, how many answers are checked);
- ``portbench/entries/<entry>.py``: one module per entry point of the
  program;
- ``portbench/checks/<workload>.json``: the limits of the cell's check;
- ``portbench/metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a configuration, mix, entry, cell or metric by adding
files, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import NamedTuple

__all__ = ["REPO", "Cell", "NAME", "UNIT", "load_benchmark", "resolve", "load_module", "entry_module", "metric_module"]

REPO = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Cell(NamedTuple):
    workload: dict  # the BENCHMARK.json entry
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # number name -> its limit
    end_to_end: list  # the cell's end-to-end metrics, in BENCHMARK.json order
    per_layer: list  # the cell's per-layer metrics
    root: Path  # where BENCHMARK.json lies


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reported(metric: dict, workload: str, bench: dict) -> bool:
    """Whether a cell reports ``metric``: its ``workloads`` list, or without
    one every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in bench["end_to_end"] if m["name"] == moves)
    return _reported(target, workload, bench)


def resolve(workload: str, root: Path = REPO) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json with its files."""
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'} (have {sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Cell(
        workload=cell,
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((root / "portbench" / "checks" / f"{workload}.json").read_text())["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, workload, bench)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, workload, bench)],
        root=root,
    )


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def entry_module(cell: Cell):
    """The module that drives the cell's entry point, ``portbench/entries/<entry>.py``."""
    entry = cell.traffic["entry"]
    return load_module(cell.root / "portbench" / "entries" / f"{entry}.py", f"portbench_entry_{entry}")


def metric_module(cell: Cell, name: str):
    """The reader of per-layer metric ``name``, ``portbench/metrics/<name>.py``:
    its ``read(ctx)`` and the program calls it needs recorded (``RECORD``)."""
    return load_module(cell.root / "portbench" / "metrics" / f"{name}.py", f"portbench_metric_{name}")
