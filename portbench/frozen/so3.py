"""SO(3) exponential and logarithm, frozen for the benchmark.

A copy of the port's ``geometry/so3.py`` (``hat``, ``exp``, ``log``) as it
stood when the benchmark was defined, so the renderer's ground truth and the
reference's projections do not move with the program.
"""

from __future__ import annotations

import torch

__all__ = ["hat", "exp", "log"]

# Below this angle the closed forms are replaced with Taylor expansions.
_SMALL_ANGLE = 1e-6


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vectors -> (..., 3, 3) skew matrices: hat(v) @ x == v x x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def exp(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) (Rodrigues)."""
    theta_sq = torch.sum(rvec * rvec, dim=-1)
    small = theta_sq < _SMALL_ANGLE**2
    safe_theta_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_theta = torch.sqrt(safe_theta_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_theta) / safe_theta)
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_theta)) / safe_theta_sq
    )
    k = hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def log(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3), angle in [0, pi].

    The pi-safe branch structure of ``meatmodeler_tpu.geometry.so3.log``:
    atan2 angle, a Taylor branch near the identity, and the diagonal-based
    axis extraction once theta > 2 (the skew formula amplifies float32
    noise by th / sin(th) there).
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    skew = torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    ) * 0.5
    sin_sq = torch.sum(skew * skew, dim=-1)
    small = (sin_sq < _SMALL_ANGLE**2) & (cos_theta > 0.0)
    sin_zero = sin_sq < _SMALL_ANGLE**2
    sin_norm = torch.sqrt(torch.where(sin_zero, torch.ones_like(sin_sq), sin_sq))
    theta = torch.atan2(torch.where(sin_zero, torch.zeros_like(sin_norm), sin_norm), cos_theta)
    near_pi = theta > 2.0

    sin_theta = torch.sin(torch.where(small | near_pi, torch.ones_like(theta), theta))
    generic = skew * (theta / sin_theta)[..., None]
    small_branch = skew * (1.0 + sin_sq / 6.0)[..., None]

    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], dim=-1)
    one_minus_cos = torch.where(near_pi, 1.0 - cos_theta, torch.ones_like(cos_theta))
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / one_minus_cos[..., None], 0.0, 1.0
    )
    axis_ok = near_pi[..., None] & (axis_sq > _SMALL_ANGLE**2)
    axis_abs = torch.where(
        axis_ok,
        torch.sqrt(torch.where(axis_ok, axis_sq, torch.ones_like(axis_sq))),
        torch.zeros_like(axis_sq),
    )
    sym01 = rot[..., 0, 1] + rot[..., 1, 0]
    sym02 = rot[..., 0, 2] + rot[..., 2, 0]
    sym12 = rot[..., 1, 2] + rot[..., 2, 1]
    major = torch.argmax(axis_abs, dim=-1)

    def sgn(s):
        return torch.where(s < 0, -torch.ones_like(s), torch.ones_like(s))

    a0, a1, a2 = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    x0 = torch.where(major == 0, a0, torch.where(major == 1, a0 * sgn(sym01), a0 * sgn(sym02)))
    x1 = torch.where(major == 0, a1 * sgn(sym01), torch.where(major == 1, a1, a1 * sgn(sym12)))
    x2 = torch.where(major == 0, a2 * sgn(sym02), torch.where(major == 1, a2 * sgn(sym12), a2))
    pi_axis = torch.stack([x0, x1, x2], dim=-1)
    align = torch.sum(pi_axis * skew, dim=-1)
    pi_axis = pi_axis * sgn(align)[..., None]
    pi_branch = pi_axis * theta[..., None]

    out = torch.where(small[..., None], small_branch, generic)
    return torch.where(near_pi[..., None], pi_branch, out)
