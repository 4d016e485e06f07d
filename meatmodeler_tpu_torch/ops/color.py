"""Colour-space conversions, BGR <-> grey / LAB (torch twin of
``meatmodeler_tpu/ops/color.py``).

OpenCV's 8-bit conventions: BT.601 grey weights; CIE LAB on sRGB-linearized
RGB with L scaled to [0, 255] and a/b offset by 128. Everything is float32
elementwise math over (..., H, W, 3) tensors.

torch has no ``cbrt``: the cube root above the CIE knee is ``t ** (1/3)``,
which can differ from ``jnp.cbrt`` in the last ulp. L then differs by ~1e-5,
so a pixel whose L sits within that of an x.5 can round into the
neighbouring CLAHE bin (see ``tests/test_torch_color_klt.py`` for the
tolerance this gives the enhanced grey).
"""

from __future__ import annotations

import torch

__all__ = ["bgr_to_grey", "bgr_to_lab", "lab_to_bgr"]

# sRGB (D65) <-> XYZ, as in OpenCV's Lab conversion.
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.53715, -0.498535),
    (-0.969256, 1.875991, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
# D65 white point applied to X and Z.
_WHITE = (0.950456, 1.0, 1.088754)


def _matvec3(m, v: torch.Tensor) -> torch.Tensor:
    """Unrolled 3x3 @ (..., 3), the reference's summation order."""
    c0, c1, c2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([m[i][0] * c0 + m[i][1] * c1 + m[i][2] * c2 for i in range(3)], dim=-1)


def bgr_to_grey(bgr: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of (..., H, W, 3) B,G,R in [0, 255]; float32 (..., H, W)."""
    x = bgr.to(torch.float32)
    return 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]


def _f_cbrt(t: torch.Tensor) -> torch.Tensor:
    """CIE f(t): cube root above the 0.008856 knee, linear segment below."""
    return torch.where(t > 0.008856, torch.clamp(t, min=0.0) ** (1.0 / 3.0), 7.787 * t + 16.0 / 116.0)


def _srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0.04045, ((v + 0.055) / 1.055) ** 2.4, v / 12.92)


def _linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(v, min=0.0)
    return torch.where(v > 0.0031308, 1.055 * v ** (1.0 / 2.4) - 0.055, 12.92 * v)


def bgr_to_lab(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_BGR2LAB for 8-bit images: (..., H, W, 3) B,G,R in [0, 255]
    -> float32 [L, a, b] with L in [0, 255] and a/b offset by 128."""
    rgb = _srgb_to_linear(bgr.to(torch.float32).flip(-1) / 255.0)
    xyz = _matvec3(_RGB2XYZ, rgb)
    fx = _f_cbrt(xyz[..., 0] / _WHITE[0])
    fy = _f_cbrt(xyz[..., 1] / _WHITE[1])
    fz = _f_cbrt(xyz[..., 2] / _WHITE[2])
    l_star = 116.0 * fy - 16.0
    a_star = 500.0 * (fx - fy)
    b_star = 200.0 * (fy - fz)
    return torch.stack([l_star * (255.0 / 100.0), a_star + 128.0, b_star + 128.0], dim=-1)


def lab_to_bgr(lab: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bgr_to_lab`: float32 B,G,R clipped to [0, 255]."""
    l_star = lab[..., 0] * (100.0 / 255.0)
    a_star = lab[..., 1] - 128.0
    b_star = lab[..., 2] - 128.0
    fy = (l_star + 16.0) / 116.0
    fx = fy + a_star / 500.0
    fz = fy - b_star / 200.0

    def f_inv(f):
        t = f * f * f
        return torch.where(t > 0.008856, t, (f - 16.0 / 116.0) / 7.787)

    xyz = torch.stack([f_inv(fx) * _WHITE[0], f_inv(fy) * _WHITE[1], f_inv(fz) * _WHITE[2]], dim=-1)
    rgb = _linear_to_srgb(_matvec3(_XYZ2RGB, xyz))
    return torch.clamp(rgb.flip(-1) * 255.0, 0.0, 255.0)
