"""Per-stage wall-clock timings and counters (torch twin of
``meatmodeler_tpu/utils/profiling.py``).

CUDA work is asynchronous: a stage's wall-clock normally measures the time
to enqueue it, and the compute is billed to whichever later stage first
reads a result back. ``MEATMODELER_SYNC_STAGES=1`` synchronises the device
at every stage exit so the timings attribute truthfully, at the cost of the
overlap between stages.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict

import torch

logger = logging.getLogger("meatmodeler")

__all__ = ["Metrics", "trace", "logger", "device_barrier", "profile_run"]


def _sync_stages() -> bool:
    # Read at each stage exit, so a process can time some runs synced and
    # others not.
    return os.environ.get("MEATMODELER_SYNC_STAGES", "") not in ("", "0")


def device_barrier() -> None:
    """Block until the work queued so far on the current CUDA device is done
    (nothing to wait for where CUDA was never used)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(name: str):
    """A ``torch.profiler`` range named ``name`` around the enclosed work
    (a named slice in a ``profile_run`` trace; near-free otherwise)."""
    with torch.profiler.record_function(name):
        yield


class Metrics:
    """Accumulates per-stage wall times and arbitrary counters."""

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}
        self.counters: Dict[str, Any] = {}
        self._pending: Dict[str, Any] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with trace(name):
            yield
            if _sync_stages():
                device_barrier()
        dt = time.perf_counter() - t0
        self.timings[name] = self.timings.get(name, 0.0) + dt
        logger.info("%s: %.3fs", name, dt)

    def count(self, name: str, value) -> None:
        self.counters[name] = value
        logger.info("%s = %s", name, value)

    def add(self, name: str, value) -> None:
        """Accumulating counter (``count`` overwrites)."""
        self.counters[name] = self.counters.get(name, 0) + value

    def count_async(self, name: str, value: torch.Tensor, convert=None) -> None:
        """Defer a device-resident counter: no device read here. It is
        converted at ``as_dict()``, after the pipeline's last required read
        (``convert`` maps the CPU tensor to its recorded form; default
        ``.item()`` for scalars, ``.tolist()`` otherwise)."""
        self._pending[name] = (value, convert)

    def flush(self) -> None:
        pending, self._pending = self._pending, {}
        for name, (v, convert) in pending.items():
            v = v.detach().cpu()
            if convert is not None:
                out = convert(v)
            elif v.ndim == 0:
                out = v.item()
            else:
                out = v.tolist()
            self.counters[name] = out
            logger.info("%s = %s", name, out)

    def as_dict(self) -> Dict[str, Any]:
        self.flush()
        return {"timings": dict(self.timings), "counters": dict(self.counters)}


@contextlib.contextmanager
def profile_run():
    """A ``torch.profiler`` trace of the enclosed run (host and, where there
    is a card, CUDA activity) written as a chrome trace into the directory
    ``MEATMODELER_PROFILE=<dir>`` names (view it in ui.perfetto.dev). No-op
    when the variable is unset."""
    out_dir = os.environ.get("MEATMODELER_PROFILE")
    if not out_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
