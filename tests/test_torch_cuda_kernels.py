"""The hand-written CLAHE CUDA kernels against their plain PyTorch versions,
on the card. Skipped without CUDA (the kernels have no CPU mode).

This file imports no JAX, so it also runs where JAX is absent, without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from meatmodeler_tpu_torch.ops import clahe as tclahe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,tiles", [((4, 540, 960), (8, 8)), ((2, 67, 120), (8, 8)), ((1, 64, 80), (4, 4))]
)
def test_cuda_kernels_match_reference(cuda, shape, tiles):
    from meatmodeler_tpu_torch.ops import clahe_cuda

    img = torch.from_numpy(
        np.random.default_rng(11).integers(0, 256, size=shape).astype(np.float32)
    ).to(cuda)
    before = dict(clahe_cuda.LAUNCHES)
    lut = clahe_cuda.clahe_lut(img, 3.5, tiles)
    lut_ref = tclahe.lut_reference(img, 3.5, tiles)
    out = clahe_cuda.clahe_apply(img, lut_ref, tiles)
    torch.cuda.synchronize()
    # Integer counts: the LUTs are exact.
    assert torch.equal(lut, lut_ref)
    torch.testing.assert_close(out, tclahe.apply_reference(img, lut_ref, tiles), atol=1e-3, rtol=0)
    torch.testing.assert_close(
        tclahe.clahe(img, tiles=tiles), tclahe.clahe_reference(img, tiles=tiles), atol=1e-3, rtol=0
    )
    assert clahe_cuda.LAUNCHES["clahe_lut"] == before["clahe_lut"] + 2
    assert clahe_cuda.LAUNCHES["clahe_apply"] == before["clahe_apply"] + 2


@pytest.mark.gpu
def test_cuda_kernels_reject_bad_input(cuda):
    from meatmodeler_tpu_torch.ops import clahe_cuda

    with pytest.raises(ValueError, match="float32"):
        clahe_cuda.clahe_lut(torch.zeros(1, 32, 32, dtype=torch.float16, device=cuda), 3.5, (4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        clahe_cuda.clahe_lut(torch.zeros(1, 32, 64, device=cuda)[:, :, ::2], 3.5, (4, 4))
    with pytest.raises(ValueError, match="bad LUT"):
        clahe_cuda.clahe_apply(torch.zeros(1, 32, 32, device=cuda), torch.zeros(1, 8, 256, device=cuda), (4, 4))
