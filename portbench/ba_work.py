"""Bytes of the BA Jacobian kernel (``csrc/ba_jac.cu::obs_jacobians_kernel``)
for its roofline share (``metrics/roofline_pct.ba_jac.py``).

A call of ``solvers.bundle_adjust_cuda.obs_jacobians`` reads the cameras,
points, intrinsics, both index lists, the mask and the weights, and writes
each observation's (2, 6) camera and (2, 3) point Jacobian rows; the
residuals are formed outside the kernel. Each input is counted read once
and each output written once, whatever the kernel reads again (a camera's
and a point's parameters are gathered once an observation).
"""

from __future__ import annotations

__all__ = ["obs_jacobians_bytes"]


def obs_jacobians_bytes(args) -> int:
    """``args``: a recorded call's (cam, pts, intrinsics, fidx, pidx, mask,
    weight), each with an optional leading lane axis."""
    cam, pts, intrinsics, fidx, pidx, mask, weight = args
    inputs = [cam, pts, intrinsics, fidx, pidx, mask] + ([] if weight is None else [weight])
    read = sum(t.numel() * t.element_size() for t in inputs)
    written = fidx.numel() * (2 * 6 + 2 * 3) * cam.element_size()
    return read + written
