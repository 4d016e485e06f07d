"""Umeyama similarity alignment — scoring up-to-scale reconstructions (the
port's copy of ``meatmodeler_tpu/utils/alignment.py``).

The marker-free path (``pipeline._chain_keyframe_poses``) outputs a
reconstruction in an arbitrary monocular gauge: world frame = keyframe 0's
camera, scale = the first baseline. Comparing it to ground truth needs the
best-fit similarity transform first (closed form: Umeyama 1991,
"Least-squares estimation of transformation parameters between two point
patterns").

NumPy, host-side: alignment is an evaluation tool, not a pipeline stage.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["SimilarityTransform", "umeyama", "aligned_rmse"]


class SimilarityTransform(NamedTuple):
    scale: float
    rotation: np.ndarray  # (3, 3)
    translation: np.ndarray  # (3,)

    def apply(self, pts: np.ndarray) -> np.ndarray:
        return self.scale * pts @ self.rotation.T + self.translation


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True) -> SimilarityTransform:
    """Least-squares similarity transform mapping ``src`` onto ``dst``.

    Args:
      src, dst: (N, 3) corresponding point sets (N >= 3, non-degenerate).
      with_scale: solve for scale too (False = rigid).

    Returns:
      SimilarityTransform minimizing ``||dst - (s R src + t)||^2`` with R a
      proper rotation (det +1; reflections excluded via the sign trick).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if not (src.shape == dst.shape and src.ndim == 2 and src.shape[1] == 3 and len(src) >= 3):
        raise ValueError(f"umeyama needs two (N >= 3, 3) point sets, got {src.shape} and {dst.shape}")
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)  # (3, 3)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    rot = u @ s @ vt
    var_s = (sc * sc).sum() / len(src)
    scale = float(np.trace(np.diag(d) @ s) / max(var_s, 1e-30)) if with_scale else 1.0
    t = mu_d - scale * rot @ mu_s
    return SimilarityTransform(scale, rot, t)


def aligned_rmse(src: np.ndarray, dst: np.ndarray, with_scale: bool = True) -> float:
    """RMS point distance after the best-fit similarity alignment."""
    tf = umeyama(src, dst, with_scale=with_scale)
    r = tf.apply(np.asarray(src, np.float64)) - np.asarray(dst, np.float64)
    return float(np.sqrt((r * r).sum(axis=1).mean()))
