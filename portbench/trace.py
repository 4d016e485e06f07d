"""The traced window: ``torch.profiler`` over a few calls, read back.

From the chrome trace it takes the device's busy time (the union of kernel,
copy and memset intervals, ``frozen/busy.py``), the kernel launches, the
device time of each kernel by name, and the idle gaps between device work,
each named by the innermost host range that encloses it (the program's
stages are ``record_function`` ranges; the harness adds one per call). The
profiler slows the host, so the idle share it gives is a ceiling of the
untraced run's.

While the window runs, the program calls that the cell's per-layer readers
name in their ``RECORD`` lists keep their arguments (references only: no
read of the device inside the window), for the readers' work counts.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import inspect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from portbench.frozen.busy import DEVICE_CATEGORIES, device_busy
from portbench.patches import Patches

__all__ = ["recording", "traced", "summarize"]

CALL_RANGE = "portbench.call"


@contextlib.contextmanager
def recording(targets):
    """Within the block, each ``"module:function"`` of ``targets`` keeps the
    positional arguments of its calls, defaults applied, in the dict the
    block receives (name -> list of argument tuples)."""
    calls = defaultdict(list)
    patches = Patches()

    def keeper(name):
        def make(real):
            sig = inspect.signature(real)

            def call(*args, **kwargs):
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                calls[name].append(tuple(bound.arguments.values()))
                return real(*args, **kwargs)

            return call

        return make

    for target in targets:
        mod_name, name = target.split(":")
        patches.replace(importlib.import_module(mod_name), name, keeper(name))
    try:
        yield calls
    finally:
        patches.close()


def traced(run, items, targets):
    """Run ``run(item)`` for each of ``items`` under the profiler, each in a
    range ``CALL_RANGE``. Returns (results, trace summary, recorded calls)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with recording(targets) as calls:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            results = []
            for item in items:
                with torch.profiler.record_function(CALL_RANGE):
                    results.append(run(item))
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    summary = summarize(events, window_s)
    summary["calls"] = len(items)
    return results, summary, dict(calls)


def summarize(events, window_s: float) -> dict:
    """Busy seconds, kernel launches, kernel seconds by name and idle
    seconds by enclosing host range, of chrome-trace ``events``."""
    busy_ms, launches = device_busy(events)
    kernels = defaultdict(float)
    spans, ranges = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            spans.append((start, start + dur))
            if cat == "kernel":
                kernels[ev.get("name", "?")] += dur / 1e6
        elif cat == "user_annotation":
            ranges.append((start, start + dur, ev.get("name", "?")))
    return {
        "busy_s": busy_ms / 1e3,
        "window_s": window_s,
        "launches": launches,
        "kernel_s": dict(kernels),
        "idle_s": _idle_by_range(spans, ranges),
    }


def _idle_by_range(spans, ranges) -> dict:
    """The gaps between merged device intervals, from the first host range's
    start to the last one's end, in seconds summed by the name of the
    innermost host range around each part of them."""
    if not ranges:
        return {}
    lo, hi = min(r[0] for r in ranges), max(r[1] for r in ranges)
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps, cursor = [], lo
    for a, b in merged:
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
    if cursor < hi:
        gaps.append((cursor, hi))
    # Split each gap where a host range starts or ends, and name each piece
    # by the innermost range around it.
    cuts = sorted({x for r in ranges for x in r[:2]})
    idle = defaultdict(float)
    for a, b in gaps:
        edges = [a] + [x for x in cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]] + [b]
        for lo_, hi_ in zip(edges, edges[1:]):
            if hi_ <= lo_:
                continue
            mid = 0.5 * (lo_ + hi_)
            inner = [r for r in ranges if r[0] <= mid <= r[1]]
            name = max(inner, key=lambda r: (r[0], -r[1]))[2] if inner else "outside"
            idle[name] += (hi_ - lo_) / 1e6
    return dict(idle)
