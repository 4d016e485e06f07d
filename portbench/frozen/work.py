"""Work counts and the chip's peaks, frozen for the benchmark.

Copies of the port's ``tools/clahe_bench`` byte counts and of
``tools/relpose_bench.hyp_work`` with its operation constants, as they
stood when the benchmark was defined. A kernel's roofline share is the
least time these counts allow at the peaks, over its device time.
"""

from __future__ import annotations

from typing import Dict

__all__ = [
    "FP32_FLOPS_PER_S", "HBM_BYTES_PER_S", "clahe_lut_bytes", "clahe_apply_bytes", "hyp_work", "least_seconds",
]

# One H100 SXM (NVIDIA's data sheet, at its 700 W limit): float32 outside
# the tensor cores, and HBM3 bandwidth.
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time a call can take: the larger of its operations at the
    float32 peak and its bytes at the memory peak."""
    return max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def clahe_lut_bytes(shape, tiles=(8, 8)) -> int:
    """``clahe_lut`` on (B, H, W) float32: the image read once, the LUTs
    written once."""
    b, h, w = shape
    return 4 * (b * h * w + b * tiles[0] * tiles[1] * 256)


def clahe_apply_bytes(shape, tiles=(8, 8)) -> int:
    """``clahe_apply``: the image and the LUTs read once, the output written
    once."""
    b, h, w = shape
    return 4 * (2 * b * h * w + b * tiles[0] * tiles[1] * 256)


# A 9x9 Jacobi sweep is 36 rotations of ~110 operations; six sweeps reach
# float32 rounding. A 3x3 SVD: ~900.
JACOBI_SWEEPS = 6
EIG9_OPS = JACOBI_SWEEPS * 36 * 110
SVD3_OPS = 900
ESSENTIAL_SOLVE_OPS = 8 * 4 * 2 + 8 * 45 * 2 + EIG9_OPS + 2 * SVD3_OPS + 2 * 27 * 2 + 200
HOMOGRAPHY_SOLVE_OPS = 2 * 30 + 8 * 45 * 2 + EIG9_OPS + 2 * 27 * 2 + 9 + 30
SAMPSON_OPS = 28
TRANSFER_OPS = 50
POLISH_SLOT_OPS = 2 * TRANSFER_OPS + 2 * 2 * 45 * 2
DECOMPOSE_OPS = 2000
MIDPOINT_OPS = 45
DECOMP_OPS = SVD3_OPS + 4 * 27 + 60
SCORE_SLOT_OPS = SAMPSON_OPS + MIDPOINT_OPS + 15 + 12 + 6

# Where each dispatch point's positional arguments hold the mask.
_MASK_ARG = {"essential_hypotheses": 2, "homography_hypotheses": 2, "homography_polish": 2, "recover_pose": 3,
             "score_candidates": 4}


def hyp_work(name: str, args) -> Dict[str, int]:
    """Operations and bytes one call of the relative pose's dispatch point
    ``name`` (``essential_hypotheses``, ``homography_hypotheses``,
    ``homography_polish``, ``recover_pose``, ``score_candidates``) needs on
    its positional arguments ``args`` (defaults applied): the solves per
    hypothesis and, per slot in the mask, each hypothesis' consensus test,
    the polish's transfer errors and normal matrices, a candidate's four
    midpoint triangulations and votes, a scored candidate's residual,
    triangulation and reprojection. Bytes: inputs read once, outputs
    written once."""
    mask = args[_MASK_ARG[name]]
    n = mask.shape[-1]
    valid = int(mask.sum()) if mask.ndim == 1 else int(mask.sum()) // max(1, mask.shape[0])
    fb = args[0].element_size()
    pts = 2 * n * 2 * fb + n + 9 * fb
    if name == "essential_hypotheses":
        h = args[4].shape[0]
        return {"flops": h * (ESSENTIAL_SOLVE_OPS + SAMPSON_OPS * valid), "bytes": pts + h * 64 + fb + h * (9 * fb + 8)}
    if name == "homography_hypotheses":
        h = args[3].shape[0]
        return {"flops": h * (HOMOGRAPHY_SOLVE_OPS + TRANSFER_OPS * valid), "bytes": pts + h * 32 + h * (9 * fb + 8)}
    if name == "homography_polish":
        h = args[3].shape[0]
        return {"flops": h + POLISH_SLOT_OPS * valid + 2 * EIG9_OPS + DECOMPOSE_OPS,
                "bytes": pts + h * (9 * fb + 8) + 9 * fb + n * (fb + 1) + 48 * fb}
    if name == "recover_pose":
        b = args[0].shape[0]
        return {"flops": b * (DECOMP_OPS + valid * (SAMPSON_OPS + 4 * MIDPOINT_OPS)),
                "bytes": pts + b * 9 * fb + (b - 1) * n * (mask.ndim == 2) + fb + b * (6 * fb + 32)}
    if name != "score_candidates":
        raise ValueError(f"no work count for {name!r}")
    c = args[0].shape[0]
    return {"flops": c * (50 + DECOMP_OPS + 100 + valid * (SCORE_SLOT_OPS + 4 * MIDPOINT_OPS)),
            "bytes": pts + c * 6 * fb + fb + c * (8 + fb + 6 * fb + 9 * fb + n * (fb + 1))}
