"""Sobel gradients, windowed structure tensor and Harris response (torch
twin of the parts of ``meatmodeler_tpu/ops/features.py`` that ORB uses).

Filters run as ``conv2d`` on replicate-padded (B, 1, H, W) stacks. cuDNN
would run a float32 convolution in TF32 on the card; ``pipeline.process``
turns TF32 off, so these stay full float32 like the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["sobel", "harris_response"]

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _conv2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Same-size 2-D correlation of (B, H, W) with replicate borders."""
    kh, kw = kernel.shape
    x = F.pad(img[:, None], (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    return F.conv2d(x, kernel[None, None].to(img.dtype))[:, 0]


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel derivatives (Ix, Iy) of (B, H, W) images."""
    kx = torch.tensor(_SOBEL_X, dtype=img.dtype, device=img.device)
    return _conv2(img, kx), _conv2(img, kx.T.contiguous())


def _box(img: torch.Tensor, size: int) -> torch.Tensor:
    """Unnormalized box sum over a size x size window."""
    return _conv2(img, torch.ones((size, size), dtype=img.dtype, device=img.device))


def harris_response(img: torch.Tensor, block_size: int = 7, k: float = 0.04) -> torch.Tensor:
    """Harris cornerness det - k*trace^2 (cv2.cornerHarris scaling)."""
    ix, iy = sobel(img)
    a, b, c = _box(ix * ix, block_size), _box(ix * iy, block_size), _box(iy * iy, block_size)
    scale = 1.0 / (4.0 * 255.0 * block_size) ** 2
    det = a * c - b * b
    tr = a + c
    return (det - k * tr * tr) * scale * scale
