"""Copies of program code that the benchmark measures with, frozen when the
benchmark was defined: the scene and its renderer, the accuracy arithmetic,
the device-busy arithmetic and the kernels' work counts."""
