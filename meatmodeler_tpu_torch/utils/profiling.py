"""Spans, per-stage wall-clock timings and counters (torch twin of
``meatmodeler_tpu/utils/profiling.py``).

One primitive, ``trace(name)``, marks a span of work on the current thread.
Spans nest: each has a path, ``<top-level stage>/<child>/...`` (for example
``pass1_keyframes/scan`` or ``pose_ba/decide``), from a per-thread stack of
open spans, so code deep in ``ops/`` or ``solvers/`` names only its own part.
A ``Metrics.stage`` is a span that starts a path of its ``Metrics``; a span
opened inside it attaches to that ``Metrics`` and adds its wall seconds to
``timings[<path>]``. A span opened where no ``Metrics`` is open on the
thread times nothing. While a ``torch.profiler`` is active, every span is a
``record_function`` range named by its full path, on the same clock as the
kernels; otherwise a span costs a flag check and a ``perf_counter`` pair.

CUDA work is asynchronous: a span's wall-clock normally measures the time
to enqueue its work, and the compute is billed to whichever later span
first reads a result back. ``MEATMODELER_SYNC_STAGES=1`` synchronises the
device at every span's exit so the timings attribute truthfully, at the
cost of the overlap between spans. It also counts host reads: while a
stage is open, CUDA's sync debug mode is held at "warn", and each
"synchronizing" warning adds 1 to the counter ``host_reads:<path>`` of the
innermost open span of the thread that issued it (the exit barrier itself
is not counted, and nothing is printed).
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import threading
import time
import warnings
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger("meatmodeler")

__all__ = ["Metrics", "trace", "span_path", "span_add", "logger", "device_barrier", "profile_run"]

# The text of CUDA's sync debug warning (``torch.cuda.set_sync_debug_mode``).
SYNC_WARNING = "called a synchronizing CUDA operation"

_local = threading.local()


def _sync_stages() -> bool:
    # Read at each stage, so a process can time some runs synced and others
    # not.
    return os.environ.get("MEATMODELER_SYNC_STAGES", "") not in ("", "0")


def device_barrier() -> None:
    """Block until the work queued so far on the current CUDA device is done
    (nothing to wait for where CUDA was never used)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _stack() -> list:
    """This thread's open spans, innermost last: (path, Metrics or None,
    synced)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span_path() -> Optional[str]:
    """The path of the innermost open span of this thread (None outside
    every span)."""
    stack = _stack()
    return stack[-1][0] if stack else None


def span_add(name: str, value) -> None:
    """Add ``value`` to the counter ``<name>:<path>`` of the innermost open
    span's ``Metrics`` (nothing where no ``Metrics`` is open)."""
    stack = _stack()
    if stack and stack[-1][1] is not None:
        stack[-1][1].add(f"{name}:{stack[-1][0]}", value)


class _HostReads:
    """The process-wide hook behind the ``host_reads:<path>`` counters: held
    by every open stage under ``MEATMODELER_SYNC_STAGES``; the first holder
    installs it (sync debug mode "warn", a warnings filter that shows every
    occurrence, a ``showwarning`` that counts), the last one restores the
    caller's mode, filter list and ``showwarning``."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.holders = 0
        self.saved_mode = 0
        self.saved_show = None
        self.filter = None

    def show(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            if getattr(_local, "barrier", False):
                return
            stack = _stack()
            if stack and stack[-1][2]:
                stack[-1][1].add(f"host_reads:{stack[-1][0]}", 1)
                return
        self.saved_show(message, category, filename, lineno, file, line)

    def hold(self) -> None:
        with self.lock:
            self.holders += 1
            if self.holders > 1:
                return
            self.saved_show = warnings.showwarning
            warnings.showwarning = self.show
            warnings.filterwarnings("always", message=re.escape(SYNC_WARNING))
            self.filter = warnings.filters[0]
            if torch.cuda.is_available():
                self.saved_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")

    def release(self) -> None:
        with self.lock:
            self.holders -= 1
            if self.holders > 0:
                return
            if torch.cuda.is_available():
                torch.cuda.set_sync_debug_mode(self.saved_mode)
            # A ``warnings.catch_warnings`` block that ended meanwhile has
            # put back its own filters and ``showwarning``: leave those.
            if warnings.showwarning == self.show:
                warnings.showwarning = self.saved_show
            if self.filter in warnings.filters:
                warnings.filters.remove(self.filter)
                getattr(warnings, "_filters_mutated", lambda: None)()
            self.saved_show = self.filter = None


_HOST_READS = _HostReads()


class _Span:
    """One open span (``trace``, ``Metrics.stage``)."""

    __slots__ = ("name", "owner", "path", "metrics", "synced", "range", "t0")

    def __init__(self, name: str, owner: Optional["Metrics"] = None) -> None:
        self.name = name
        self.owner = owner  # the Metrics of a stage; None for a plain span

    def __enter__(self) -> "_Span":
        stack = _stack()
        outer_path, outer_metrics, outer_synced = stack[-1] if stack else (None, None, False)
        if self.owner is None:
            self.metrics, self.synced = outer_metrics, outer_synced
            self.path = self.name if outer_path is None else f"{outer_path}/{self.name}"
        else:
            # The variable is read once a stage; its spans inherit it.
            self.metrics, self.synced = self.owner, _sync_stages()
            self.path = f"{outer_path}/{self.name}" if outer_metrics is self.owner else self.name
            if self.synced:
                _HOST_READS.hold()
        stack.append((self.path, self.metrics, self.synced))
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.path)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        try:
            if self.synced and exc[0] is None:
                _local.barrier = True
                try:
                    device_barrier()
                finally:
                    _local.barrier = False
            if self.range is not None:
                self.range.__exit__(*exc)
        finally:
            _stack().pop()
            if self.synced and self.owner is not None:
                _HOST_READS.release()
        if self.metrics is not None:
            dt = time.perf_counter() - self.t0
            timings = self.metrics.timings
            timings[self.path] = timings.get(self.path, 0.0) + dt
            if self.owner is not None:
                logger.info("%s: %.3fs", self.path, dt)
        return False


def trace(name: str) -> _Span:
    """A span named ``name`` around the enclosed work (``with
    trace("describe"): ...``): its path is the enclosing span's path plus
    ``/name``; it times into the innermost open ``Metrics`` of the thread
    and, under a profiler, is a range named by the path."""
    return _Span(name)


class Metrics:
    """Accumulates span wall times (by path) and arbitrary counters."""

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}
        self.counters: Dict[str, Any] = {}
        self._pending: Dict[str, Any] = {}

    def stage(self, name: str) -> _Span:
        """A span that starts a path of this ``Metrics`` (a top-level stage;
        nested in another of its stages, a child of that one)."""
        return _Span(name, self)

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
    is a card, CUDA activity, with every span a range named by its path)
    written as a chrome trace into the directory ``MEATMODELER_PROFILE=<dir>``
    names (view it in ui.perfetto.dev). No-op when the variable is unset or
    a profiler is already running."""
    out_dir = os.environ.get("MEATMODELER_PROFILE")
    if not out_dir or torch.autograd._profiler_enabled():
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
