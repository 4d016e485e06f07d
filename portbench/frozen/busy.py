"""Device busy time from a profiler trace, frozen for the benchmark.

A copy of ``tools/profile_headline._device_busy`` as it stood when the
benchmark was defined, taking the parsed chrome-trace events: the device is
busy where a kernel, a memcpy or a memset runs, and the union of those
intervals is its busy time.
"""

from __future__ import annotations

__all__ = ["DEVICE_CATEGORIES", "device_busy"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(events):
    """(busy ms, kernel launches) of chrome-trace ``events``: the union of
    the device's kernel, memcpy and memset intervals."""
    spans, kernels = [], 0
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") == "X" and cat in DEVICE_CATEGORIES:
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            kernels += cat == "kernel"
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, kernels
