"""meatmodeler_tpu_torch — the PyTorch + CUDA port of ``meatmodeler_tpu``.

Same layout and names as the JAX package, which stays the numerical
reference: every module here has a counterpart there, and the tests in
``tests/test_torch_*.py`` hold each pair to a stated tolerance on the same
inputs. Plain tensor code is PyTorch; the JAX package's Pallas kernels are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use.

The package never imports JAX (nor OpenCV). It reuses the JAX package's
JAX-free modules as they are: ``config``, ``io.video``, ``io.ply``,
``io.native_ops``, ``io.native_pass1``, ``utils.checkpoint`` and the numpy
parts of ``io.synthetic``.
"""

__version__ = "0.1.0"

from meatmodeler_tpu.config import (  # noqa: F401
    DEFAULT_CONFIG,
    PipelineConfig,
)


def __getattr__(name):
    # Lazy exports, as in meatmodeler_tpu/__init__.py: `import
    # meatmodeler_tpu_torch` stays light (no torch import).
    if name in ("process", "ProcessResult"):
        from meatmodeler_tpu_torch import pipeline

        return getattr(pipeline, name)
    if name in ("adjust_points", "adjust_pose", "solve_ba", "BAProblem", "BAResult"):
        from meatmodeler_tpu_torch.solvers import bundle_adjust

        return getattr(bundle_adjust, name)
    raise AttributeError(f"module 'meatmodeler_tpu_torch' has no attribute {name!r}")
