"""Image ops (torch twins of ``meatmodeler_tpu/ops``); ``clahe`` holds the
package's hand-written CUDA kernels (``clahe_cuda`` / ``csrc/clahe.cu``)."""
