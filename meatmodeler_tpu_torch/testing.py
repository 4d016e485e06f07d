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

__all__ = ["blob_texture", "f32", "from_fields", "lk_edge_points", "pair", "seeded_normal", "tt"]


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


def blob_texture(h: int, w: int, dx: float = 0.0, dy: float = 0.0, seed: int = 3, blobs: int = 60) -> np.ndarray:
    """(h, w) float32 texture of Gaussian blobs from ``seed`` whose centres
    move by (dx, dy): an exact sub-pixel shift with no resampling, for
    tracking tests. Each blob is summed within 6 sigma of its centre."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float64)
    for _ in range(blobs):
        cy, cx = rng.uniform(20, h - 20), rng.uniform(20, w - 20)
        sy, sx = rng.uniform(2, 6), rng.uniform(2, 6)
        amp = rng.uniform(60, 200)
        y0, y1 = max(0, int(cy + dy - 6 * sy)), min(h, int(cy + dy + 6 * sy) + 2)
        x0, x1 = max(0, int(cx + dx - 6 * sx)), min(w, int(cx + dx + 6 * sx) + 2)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += amp * np.exp(-(((yy - cy - dy) / sy) ** 2 + ((xx - cx - dx) / sx) ** 2))
    return np.clip(img, 0, 255).astype(np.float32)


def lk_edge_points(h: int, w: int) -> np.ndarray:
    """(19, 2) float32 (x, y) points of an (h, w) image for Lucas-Kanade's
    edge cases: five on the border, four just beyond it, seven far outside
    (up to 1e20) and three with NaN coordinates, in that order."""
    far = 1e20
    return np.array(
        [
            [0, 0], [w - 1, h - 1], [w - 0.5, h / 2], [0.25, h - 0.25], [w / 2, 0.5],
            [-3, 50], [w + 5, 60], [100, -4.5], [w / 2, h + 5],
            [-500, h / 2], [1e6, 40], [w / 3, -1e6], [far, 100], [-far, 100], [100, far], [far, far],
            [np.nan, 50], [60, np.nan], [np.nan, np.nan],
        ],
        np.float32,
    )
