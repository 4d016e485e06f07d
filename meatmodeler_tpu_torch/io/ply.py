"""PLY point-cloud writer/reader (no pyntcloud dependency); the port's copy
of ``meatmodeler_tpu/io/ply.py``.

Replaces the reference's ``PyntCloud(pd.DataFrame(...)).to_file(path)``
terminal step (``processor.py:477-489``) with a dependency-free writer
supporting both binary (default, compact) and ASCII formats.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ["write_ply", "read_ply"]


def write_ply(path, points: np.ndarray, binary: bool = True) -> str:
    """Write an (N, 3) float point cloud to ``path`` as PLY x/y/z.

    Returns the path written (the reference writes ``<path>Cloud.ply`` and
    returns nothing, ``processor.py:480-485``; callers here get the path).
    """
    points = np.asarray(points, np.float32).reshape(-1, 3)
    path = str(path)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(points.astype("<f4").tobytes())
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode("ascii"))
    return path


def read_ply(path) -> np.ndarray:
    """Read x/y/z vertices from an ASCII or binary-little-endian PLY."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = 0
    binary = False
    props = []
    for line in header:
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n = int(parts[2])
        elif parts[0] == "format":
            binary = parts[1] == "binary_little_endian"
        elif parts[0] == "property" and len(parts) == 3:
            props.append(parts[2])
    xyz_idx = [props.index(c) for c in ("x", "y", "z")]
    if binary:
        arr = np.frombuffer(data[end:], dtype="<f4", count=n * len(props)).reshape(n, len(props))
    else:
        rows = data[end:].decode("ascii").split()
        arr = np.array(rows, np.float32).reshape(n, len(props))
    return arr[:, xyz_idx]
