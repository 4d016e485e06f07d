"""Host I/O for the port: frame sources (arrays, ``.npy``, ``.y4m``), PLY
files, the native C++ host ops and pass-1 scan, and the synthetic turntable
renderer (numpy and torch backends)."""
