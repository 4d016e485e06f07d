"""Shared helpers for the parity tests: one seeded numpy input, handed to
both frameworks in float32, and a config carried across from the JAX
package's config classes (``from_fields``).

The JAX side takes the numpy array as it is (``jnp.asarray`` keeps float32
even with ``JAX_ENABLE_X64=1``, under which the test suite runs); the torch
side gets a float32 tensor. Integer inputs keep their dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["f32", "from_fields", "pair", "seeded_normal", "tt"]


def f32(x) -> np.ndarray:
    """float32 copy of a float array; integer and bool arrays unchanged."""
    x = np.asarray(x)
    return x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) else x


def tt(x) -> torch.Tensor:
    """Tensor copy of an array (float32 for floats)."""
    return torch.from_numpy(np.array(f32(x), copy=True))


def pair(x) -> Tuple[np.ndarray, torch.Tensor]:
    """(numpy array for the JAX function, tensor for the torch function)."""
    a = np.ascontiguousarray(f32(x))
    return a, torch.from_numpy(a.copy())


def seeded_normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    """float32 normal draws from ``np.random.default_rng(seed)``."""
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def from_fields(obj, cls: Optional[type] = None):
    """This package's config (``PipelineConfig`` or a sub-config) with the
    field values of ``obj``: any object with the same fields, such as the
    JAX package's config of the same name. ``cls`` defaults to the class of
    this package's ``config`` module named like ``obj``'s type; nested
    sub-configs are rebuilt the same way. This is how the parity tests hand
    both packages one config.
    """
    from meatmodeler_tpu_torch import config as config_mod

    cls = cls or getattr(config_mod, type(obj).__name__)
    values = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(f.default):
            value = from_fields(value, type(f.default))
        values[f.name] = value
    return cls(**values)
