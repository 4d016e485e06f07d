"""Shared arithmetic of the per-layer readers (``portbench/metrics/``).

A reader's ``read(ctx)`` returns a number, or None where its cell gives it
nothing to read (the harness then leaves the metric out of the line). It
never returns 0 for a share of a roofline or a peak. ``ctx`` holds:

- ``rows``: per call of the synced window, ``{"timings": stage seconds,
  "counters": the program's counters}``;
- ``trace``: the traced window's ``busy_s``, ``window_s``, ``launches``,
  ``kernel_s`` (device seconds by kernel name), ``idle_s`` and ``calls``;
- ``recorded``: the arguments of the program calls the readers' ``RECORD``
  lists name, from the traced window.
"""

from __future__ import annotations

from typing import Iterable, Optional

from portbench.frozen.work import least_seconds

__all__ = ["stage_mean", "counter_mean", "kernel_seconds", "roofline_pct"]


def stage_mean(ctx, stages: Iterable[str]) -> Optional[float]:
    """Seconds per call spent in ``stages`` (summed), over the calls that
    ran any of them."""
    stages = tuple(stages)
    sums = [sum(r["timings"].get(s, 0.0) for s in stages) for r in ctx["rows"]
            if any(s in r["timings"] for s in stages)]
    return sum(sums) / len(sums) if sums else None


def counter_mean(ctx, name: str) -> Optional[float]:
    vals = [float(r["counters"][name]) for r in ctx["rows"] if name in r["counters"]]
    return sum(vals) / len(vals) if vals else None


def kernel_seconds(ctx, kernels: Iterable[str]) -> float:
    """Device seconds of the kernels whose trace names hold one of
    ``kernels`` (the trace gives the demangled signature)."""
    kernels = tuple(kernels)
    return sum(t for name, t in ctx["trace"]["kernel_s"].items() if any(k in name for k in kernels))


def roofline_pct(ctx, kernels: Iterable[str], work) -> Optional[float]:
    """100 x the least time of the recorded calls' ``work`` [(flops,
    bytes), ...] at the peaks, over the kernels' device time; None where
    the trace shows none of them or nothing was recorded."""
    t = kernel_seconds(ctx, kernels)
    work = list(work)
    if t <= 0.0 or not work:
        return None
    return 100.0 * sum(least_seconds(f, b) for f, b in work) / t
