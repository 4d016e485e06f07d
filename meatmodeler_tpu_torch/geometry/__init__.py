"""Geometry building blocks (torch twins of ``meatmodeler_tpu/geometry``).
The LO-RANSAC's relative-pose refinement sits on a hand-written CUDA kernel
behind ``ransac`` (``ransac_cuda`` / ``csrc/relpose.cu``), built by
``ops.cuda_build``."""
