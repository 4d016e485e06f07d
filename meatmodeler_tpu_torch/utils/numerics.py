"""NaN/Inf gates at stage boundaries (torch twin of
``meatmodeler_tpu/utils/numerics.py::check_finite``).

No-op unless ``MEATMODELER_CHECK_NUMERICS=1``: the check reads the tensors
back to the host, so it is a debug mode, not a production path.
"""

from __future__ import annotations

import os

import torch

__all__ = ["NumericsError", "checks_enabled", "check_finite", "nanmedian"]


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of a 1-D tensor, averaging the two
    middle values for an even count — ``jnp.nanmedian``'s rule
    (``torch.nanmedian`` returns the lower middle value instead). NaN when
    every entry is NaN."""
    vals = torch.sort(torch.where(torch.isnan(x), torch.inf, x)).values
    n = (~torch.isnan(x)).sum()
    lo = vals[torch.clamp((n - 1) // 2, min=0)]
    hi = vals[torch.clamp(n // 2, min=0)]
    return torch.where(n > 0, 0.5 * (lo + hi), torch.nan)


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
