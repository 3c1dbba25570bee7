"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where there is no
CUDA device; the file imports no JAX, so it runs wherever the port does:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import (act_rows, flash_attention, flex_gemm, layernorm_rows, ref,
                                 rmsnorm_rows, softmax_rows)
from repro_torch.kernels.ref import ACTIVATIONS, EPILOGUES

# the reference's sweeps (tests/test_kernels.py) plus BERT-L tile shapes
GEMM_SHAPES = [(128, 128, 128), (100, 200, 300), (7, 33, 129),
               (256, 512, 384), (1, 17, 5), (130, 257, 131),
               (512, 64, 1024), (512, 768, 768), (256, 256, 3072)]
SFU_SHAPES = [(64, 128), (100, 300), (8, 17), (256, 512), (5, 1000),
              (512, 512), (512, 768)]
# qwen3-4b's rmsnorm rows: prefill of 4 x 512 tokens (norms, q-norm,
# k-norm), decode of 4 tokens (norms, q-norm, k-norm)
RMS_SERVING = [(2048, 2560), (65536, 128), (16384, 128), (4, 2560),
               (128, 128), (32, 128)]
# (B, Hq, Hkv, Sq, Skv, D): the reference's sweep, then qwen3-4b prefill
ATTN_SHAPES = [(1, 4, 2, 64, 64, 32), (2, 8, 2, 32, 128, 64),
               (1, 2, 1, 1, 96, 32), (1, 4, 4, 50, 50, 16),
               (1, 2, 2, 1, 500, 64), (2, 6, 3, 40, 100, 32),
               (4, 32, 8, 512, 512, 128)]


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


def _bf16_tol():
    """One bf16 ulp of the output (2^-7 relative): the kernel and the
    plain version compute in fp32 and may round to neighbouring bf16."""
    return 2 ** -7, 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SFU_SHAPES + RMS_SERVING)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_rmsnorm_matches_plain(cuda, shape, tdt):
    x = torch.from_numpy(_np(shape, 24, scale=2.0)).to(cuda, tdt)
    g = torch.from_numpy(_np((shape[1],), 25)).to(cuda)
    rtol, atol = (1e-4, 1e-5) if tdt == torch.float32 else _bf16_tol()
    for gamma in (None, g):
        before = rmsnorm_rows.launches
        got = rmsnorm_rows(x, gamma)
        torch.cuda.synchronize()
        assert rmsnorm_rows.launches == before + 1 and got.dtype == tdt
        torch.testing.assert_close(got.float(),
                                   ref.rmsnorm_rows(x, gamma).float(),
                                   rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda, shape, causal, tdt):
    B, Hq, Hkv, Sq, Skv, D = shape
    q = torch.from_numpy(_np((B, Hq, Sq, D), 26)).to(cuda, tdt)
    k = torch.from_numpy(_np((B, Hkv, Skv, D), 27)).to(cuda, tdt)
    v = torch.from_numpy(_np((B, Hkv, Skv, D), 28)).to(cuda, tdt)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # fp32: tests/test_kernels.py's tolerance; bf16: its bf16 case's
    rtol, atol = (1e-4, 2e-5) if tdt == torch.float32 else (3e-2, 3e-2)
    torch.testing.assert_close(got.float(),
                               ref.mha_attention(q, k, v, causal=causal).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 511, 539, 1023])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_decode_reads_the_cache_prefix(cuda, pos, tdt):
    """qwen3-4b decode: one query over the first pos + 1 rows of a 1024-row
    cache; rows past pos hold NaN and must not be read."""
    q = torch.from_numpy(_np((4, 32, 1, 128), 29)).to(cuda, tdt)
    k = torch.from_numpy(_np((4, 8, 1024, 128), 30)).to(cuda, tdt)
    v = torch.from_numpy(_np((4, 8, 1024, 128), 31)).to(cuda, tdt)
    k[:, :, pos + 1:] = float("nan")
    v[:, :, pos + 1:] = float("nan")
    got = flash_attention(q, k, v, causal=False, kv_len=pos + 1)
    want = ref.mha_attention(q, k[:, :, :pos + 1], v[:, :, :pos + 1],
                             causal=False)
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 2e-5) if tdt == torch.float32 else (3e-2, 3e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_flash_attention_empty_rows_give_zero(cuda):
    """Causal with Sq > Skv: the first Sq - Skv rows see no key."""
    q = torch.from_numpy(_np((1, 2, 40, 32), 32)).to(cuda)
    k = torch.from_numpy(_np((1, 1, 24, 32), 33)).to(cuda)
    v = torch.from_numpy(_np((1, 1, 24, 32), 34)).to(cuda)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :, :16], torch.zeros_like(got[:, :, :16]))
    torch.testing.assert_close(got, ref.mha_attention(q, k, v, causal=True),
                               rtol=1e-4, atol=2e-5)
