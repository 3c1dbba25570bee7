"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where there is no
CUDA device; the file imports no JAX, so it runs wherever the port does:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import act_rows, flex_gemm, layernorm_rows, ref, softmax_rows
from repro_torch.kernels.ref import ACTIVATIONS, EPILOGUES

# the reference's sweeps (tests/test_kernels.py) plus BERT-L tile shapes
GEMM_SHAPES = [(128, 128, 128), (100, 200, 300), (7, 33, 129),
               (256, 512, 384), (1, 17, 5), (130, 257, 131),
               (512, 64, 1024), (512, 768, 768), (256, 256, 3072)]
SFU_SHAPES = [(64, 128), (100, 300), (8, 17), (256, 512), (5, 1000),
              (512, 512), (512, 768)]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _tol(tdtype):
    return (2e-2, 2e-2) if tdtype == torch.bfloat16 else (2e-5, 2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flex_gemm_matches_plain(cuda, shape, tdt):
    M, K, N = shape
    a = torch.from_numpy(_np((M, K), 17)).to(cuda, tdt)
    b = torch.from_numpy(_np((K, N), 18)).to(cuda, tdt)
    bias = torch.from_numpy(_np((N,), 19)).to(cuda, tdt)
    c = torch.from_numpy(_np((M, N), 20)).to(cuda, tdt)
    rtol, atol = _tol(tdt)
    for epilogue in EPILOGUES:
        for acc in (None, c):
            before = flex_gemm.launches
            got = flex_gemm(a, b, bias, epilogue=epilogue, c=acc)
            torch.cuda.synchronize()
            assert flex_gemm.launches == before + 1
            torch.testing.assert_close(
                got.float(), ref.gemm(a, b, bias, epilogue, acc).float(),
                rtol=rtol, atol=atol * K ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SFU_SHAPES)
def test_cuda_sfu_matches_plain(cuda, shape):
    x = torch.from_numpy(_np(shape, 21, scale=3.0)).to(cuda)
    g = torch.from_numpy(_np((shape[1],), 22)).to(cuda)
    bt = torch.from_numpy(_np((shape[1],), 23)).to(cuda)
    torch.testing.assert_close(softmax_rows(x), ref.softmax_rows(x),
                               rtol=1e-5, atol=1e-6)
    for gamma, beta in ((None, None), (g, None), (None, bt), (g, bt)):
        torch.testing.assert_close(layernorm_rows(x, gamma, beta),
                                   ref.layernorm_rows(x, gamma, beta),
                                   rtol=1e-4, atol=1e-5)
    for act in ACTIVATIONS:
        torch.testing.assert_close(act_rows(x, act), ref.ACT_FN[act](x),
                                   rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
