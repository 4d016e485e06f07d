"""NaN/Inf gates at stage boundaries (torch twin of
``meatmodeler_tpu/utils/numerics.py::check_finite``), and the numeric
helpers the port shares.

``check_finite`` is a no-op unless ``MEATMODELER_CHECK_NUMERICS=1``: the
check reads the tensors back to the host, so it is a debug mode, not a
production path.
"""

from __future__ import annotations

import functools
import os
import threading

import torch
from torch.overrides import TorchFunctionMode

__all__ = [
    "NumericsError", "checks_enabled", "check_finite", "checked", "load_cuda_linalg", "nanmedian",
    "one_thread_at_a_time",
]

# torch.func's forward-mode AD numbers its dual levels process-wide and
# needs them closed in the order they were opened, so two host threads
# inside ``jacfwd`` at once corrupt each other's levels. The multi-video
# entry points run the geometry on two threads. Only the plain versions take
# the lock: on the card the calibration LM, the PnP refinement, the BA
# Jacobians and the relative-pose refinement are kernels.
_FORWARD_AD_LOCK = threading.Lock()


def one_thread_at_a_time(fn):
    """``fn`` (a ``torch.func.jacfwd`` transform) behind the process-wide
    forward-AD lock, so it can be called from several host threads."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with _FORWARD_AD_LOCK:
            return fn(*args, **kwargs)

    return call


def load_cuda_linalg(device: torch.device) -> None:
    """Load torch's CUDA linear-algebra library now, on the calling thread.
    torch loads it at the first CUDA ``torch.linalg`` call, and that load is
    not thread-safe: two host threads reaching it at once fail with "lazy
    wrapper should be called at most once". The multi-video entry points
    call this before they start their worker threads."""
    if device.type == "cuda":
        torch.linalg.eigh(torch.eye(2, device=device))


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries along the last dim, averaging the two
    middle values for an even count — ``jnp.nanmedian``'s rule
    (``torch.nanmedian`` returns the lower middle value instead). NaN where
    every entry is NaN."""
    vals = torch.sort(torch.where(torch.isnan(x), torch.inf, x), dim=-1).values
    n = (~torch.isnan(x)).sum(-1, keepdim=True)
    lo = torch.gather(vals, -1, torch.clamp((n - 1) // 2, min=0))[..., 0]
    hi = torch.gather(vals, -1, torch.clamp(n // 2, min=0))[..., 0]
    return torch.where(n[..., 0] > 0, 0.5 * (lo + hi), torch.nan)


class NumericsError(RuntimeError):
    """A pipeline stage produced NaN/Inf values."""


def checks_enabled() -> bool:
    return os.environ.get("MEATMODELER_CHECK_NUMERICS", "") not in ("", "0")


def check_finite(stage: str, **arrays) -> None:
    """Raise NumericsError if any named floating tensor holds NaN/Inf."""
    if not checks_enabled():
        return
    for name, a in arrays.items():
        x = torch.as_tensor(a)
        if not x.is_floating_point():
            continue
        bad = ~torch.isfinite(x)
        n_bad = int(bad.sum())
        if n_bad:
            idx = torch.nonzero(bad)[:4].tolist()
            raise NumericsError(
                f"stage '{stage}': array '{name}' has {n_bad}/{x.numel()} "
                f"non-finite values (first at indices {idx})"
            )


class _FiniteOutputs(TorchFunctionMode):
    """Raises :class:`NumericsError` at the first torch call whose floating
    output holds a NaN or an Inf, naming the call."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        stack = [out]
        while stack:
            x = stack.pop()
            if isinstance(x, (tuple, list)):
                stack.extend(x)
            elif isinstance(x, torch.Tensor) and x.is_floating_point() and not bool(torch.isfinite(x).all()):
                name = getattr(func, "__qualname__", None) or getattr(func, "__name__", repr(func))
                raise NumericsError(f"non-finite output of {name} (shape {tuple(x.shape)})")
        return out


def checked(fn):
    """Wrap ``fn`` so that it raises :class:`NumericsError` at the first
    torch operation whose floating output is non-finite, naming that
    operation: the role of the reference's checkify float checks. Every
    operation's output is read back to test it, so this is a debug tool,
    not a production path."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _FiniteOutputs():
            return fn(*args, **kwargs)

    return run
