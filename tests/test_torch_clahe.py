"""CLAHE in the port: the plain version against the JAX oracle
(``clahe_xla``) and the Pallas kernels run in interpret mode, the device
dispatch and the kernel wrappers' refusal of CPU tensors. The hand-written
kernels themselves are held to the plain version on the card by
``test_torch_cuda_kernels.py`` and ``chip_smoke.py``. Tolerance: 1e-3
absolute on a 0..255 scale."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meatmodeler_tpu.ops.clahe import clahe_xla
from meatmodeler_tpu.ops.clahe_pallas import clahe_pallas
from meatmodeler_tpu_torch.ops import clahe as tclahe
from meatmodeler_tpu_torch.testing import tt

torch.set_num_threads(2)

CASES = [((2, 64, 80), (4, 4)), ((1, 67, 120), (8, 8)), ((1, 540, 960), (8, 8))]


def _img(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,tiles", CASES)
def test_reference_matches_xla(shape, tiles):
    img = _img(7, shape)
    ref = np.asarray(clahe_xla(jnp.asarray(img), tiles=tiles))
    got = tclahe.clahe_reference(tt(img), tiles=tiles).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_reference_matches_xla_on_float_intensities():
    """Non-integer inputs round like the reference (round-half-even)."""
    img = np.random.default_rng(3).uniform(-5.0, 260.0, size=(2, 48, 64)).astype(np.float32)
    img[0, :4, :4] = 10.5  # exact halves
    ref = np.asarray(clahe_xla(jnp.asarray(img), tiles=(4, 4)))
    np.testing.assert_allclose(tclahe.clahe_reference(tt(img), tiles=(4, 4)).numpy(), ref, atol=1e-3)


def test_reference_matches_pallas_interpret():
    img = _img(8, (2, 64, 80))
    got = np.asarray(clahe_pallas(jnp.asarray(img), tiles=(4, 4), interpret=True))
    np.testing.assert_allclose(tclahe.clahe_reference(tt(img), tiles=(4, 4)).numpy(), got, atol=1e-3)


def test_cpu_tensor_dispatches_to_reference_without_launch():
    from meatmodeler_tpu_torch.ops import clahe_cuda

    before = dict(clahe_cuda.LAUNCHES)
    img = tt(_img(9, (3, 40, 56)))
    np.testing.assert_array_equal(tclahe.clahe(img).numpy(), tclahe.clahe_reference(img).numpy())
    assert clahe_cuda.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    from meatmodeler_tpu_torch.ops import clahe_cuda

    img = tt(_img(10, (1, 32, 32)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        clahe_cuda.clahe_lut(img, 3.5, (4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        clahe_cuda.clahe_apply(img, torch.zeros(1, 16, 256), (4, 4))
