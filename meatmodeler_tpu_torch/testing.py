"""Shared helper for the parity tests: one seeded numpy input, handed to both
frameworks in float32.

The JAX side takes the numpy array as it is (``jnp.asarray`` keeps float32
even with ``JAX_ENABLE_X64=1``, under which the test suite runs); the torch
side gets a float32 tensor. Integer inputs keep their dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["f32", "pair", "seeded_normal", "tt"]


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
