"""Bundle adjustment (torch twin of ``meatmodeler_tpu/solvers``)."""
