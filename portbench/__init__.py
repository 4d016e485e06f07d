"""The benchmark of the PyTorch and CUDA port (``meatmodeler_tpu_torch``)."""
