"""meatmodeler_tpu_torch — the PyTorch + CUDA port of ``meatmodeler_tpu``.

Same layout and names as the JAX package, which stays the numerical
reference: every module here has a counterpart there, and the tests in
``tests/test_torch_*.py`` hold each pair to a stated tolerance on the same
inputs. Plain tensor code is PyTorch; the JAX package's Pallas kernels are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use.

The package stands alone: it imports neither JAX nor OpenCV, and nothing
of ``meatmodeler_tpu``, not even its modules that load no JAX. Where it
needs such a module (``config``, the host ``io`` modules,
``utils.checkpoint``, the numpy scene of ``io.synthetic``) it keeps its own
copy, with the same names and behaviour; its host C++ libraries build from
the repo's ``native/`` sources into ``build/meatmodeler_tpu_torch/``.
"""

__version__ = "0.1.0"

from meatmodeler_tpu_torch.config import (  # noqa: F401
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
    if name == "Track":
        from meatmodeler_tpu_torch.tracks import Track

        return Track
    raise AttributeError(f"module 'meatmodeler_tpu_torch' has no attribute {name!r}")
