"""Image ops (torch twins of ``meatmodeler_tpu/ops``). The package's
hand-written CUDA kernels sit behind ``clahe`` (``clahe_cuda`` /
``csrc/clahe.cu``) and ``klt`` (``klt_cuda`` / ``csrc/klt.cu``), built by
``cuda_build``, which also builds ``geometry/ransac_cuda``'s."""
