"""Host-side frame sources feeding the device pipeline (the port's copy of
``meatmodeler_tpu/io/video.py``).

Frames are handed to the pipeline in chunks sized for pass 1's keyframe
scan. Accepted sources: an in-memory ndarray (T, H, W[, 3]), a path to a
``.npy`` array, or a path to a ``.y4m`` file (decoded by the native C++
loader when built, NumPy otherwise). The JAX package also decodes any
other container through ``cv2.VideoCapture``; this package does not use
cv2, so such a path raises: decode it to ``.y4m`` or ``.npy`` first.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Union

import numpy as np

__all__ = ["FrameSource"]


class FrameSource:
    """Uniform chunked access to video frames as BGR uint8 arrays."""

    def __init__(self, source: Union[str, Path, np.ndarray]):
        if isinstance(source, np.ndarray):
            self._frames = self._normalize(source)
            return
        path = Path(source)
        if path.suffix == ".npy":
            self._frames = self._normalize(np.load(path))
        elif path.suffix == ".y4m":
            from meatmodeler_tpu_torch.io import y4m

            self._frames = self._normalize(y4m.read_y4m(path))
        else:
            raise NotImplementedError(
                f"cannot read {path.name!r}: decoding video containers other than .y4m "
                "needs cv2, which this package does not use; pass a (T, H, W[, 3]) uint8 "
                "array, a .npy or a .y4m file"
            )

    @staticmethod
    def _normalize(arr: np.ndarray) -> np.ndarray:
        if arr.ndim == 3:  # grey -> BGR
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.dtype == np.uint8:
            # No up-front copy: uint8 sources (including np.load mmaps) are
            # consumed chunk-by-chunk, so a whole-video astype/contiguous
            # copy here would cost seconds of host time for nothing.
            return arr
        return np.ascontiguousarray(arr.astype(np.uint8))

    def chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        """Yield (<=chunk_size, H, W, 3) uint8 BGR chunks until exhausted."""
        for i in range(0, len(self._frames), chunk_size):
            yield self._frames[i : i + chunk_size]
