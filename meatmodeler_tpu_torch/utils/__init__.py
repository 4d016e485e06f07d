from meatmodeler_tpu_torch.utils.profiling import Metrics, logger  # noqa: F401
