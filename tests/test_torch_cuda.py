"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where there is no
CUDA device; the file imports no JAX, so it runs wherever the port does:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import (_build, act_rows, flash_attention, flex_gemm, layernorm_rows,
                                 ref, rmsnorm_rows, softmax_rows, ssd)
from repro_torch.configs import get_config
from repro_torch.kernels.ref import ACTIVATIONS, EPILOGUES
from repro_torch.models import layers

# the modules, not the wrappers of the same name that the package exports
fa = importlib.import_module("repro_torch.kernels.flash_attention")
fg = importlib.import_module("repro_torch.kernels.flex_gemm")
sfu = importlib.import_module("repro_torch.kernels.sfu")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd")

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
# mamba2-2.7b's rmsnorm rows: the gated norm of 4 x 512 prefill tokens and
# of 4 decode tokens (its norm1 rows are qwen3-4b's 2048 x 2560 / 4 x 2560)
RMS_SSM = [(2048, 5120), (4, 5120)]
# internlm2-20b's rmsnorm rows (d_model 6144): prefill of 4 x 512 tokens
# and decode of 4
RMS_WIDE = [(2048, 6144), (4, 6144)]
# BERT-L's MMU tiles (M, K, N), DeiT-L's ragged 197-row ones (K = 197 and
# N = 197 take the scalar-staged kernel) and the -S models' N = 1
MMU_TILES = [(256, 256, 256), (512, 256, 192), (512, 512, 384),
             (512, 512, 768), (512, 768, 768), (256, 256, 3072),
             (197, 197, 768), (197, 256, 197), (197, 1024, 384),
             (1024, 32, 1)]
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
@pytest.mark.parametrize("shape", MMU_TILES)
@pytest.mark.parametrize("split", ["plan", "one_slab"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flex_gemm_tiles_with_and_without_split_k(cuda, shape, split,
                                                       tdt):
    """The main path's tiles as ``gemm_plan`` cuts them for this card (split-K
    where the output has too few blocks) and in one slab, every epilogue,
    with and without the accumulator; split-K sums the same way every run."""
    M, K, N = shape
    a = torch.from_numpy(_np((M, K), 35)).to(cuda, tdt)
    b = torch.from_numpy(_np((K, N), 36)).to(cuda, tdt)
    bias = torch.from_numpy(_np((N,), 37)).to(cuda, tdt)
    c = torch.from_numpy(_np((M, N), 38)).to(cuda, tdt)
    plan = fg.gemm_plan(M, K, N, _build.sm_count(cuda))
    if split == "one_slab":
        plan = fg.GemmPlan(plan.blocks, 1, max(1, -(-K // fg.BLOCK_K)))
    rtol, atol = _tol(tdt)
    for epilogue in EPILOGUES:
        for acc in (None, c):
            got = fg._launch(a, b, bias, epilogue, acc, plan)
            again = fg._launch(a, b, bias, epilogue, acc, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            torch.testing.assert_close(
                got.float(), ref.gemm(a, b, bias, epilogue, acc).float(),
                rtol=rtol, atol=atol * K ** 0.5)
    before = flex_gemm.launches
    flex_gemm(a, b, c=c)
    assert flex_gemm.launches == before + 1


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
@pytest.mark.parametrize("shape", SFU_SHAPES + RMS_SERVING + RMS_SSM
                         + RMS_WIDE)
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


def _offset_view(shape, seed, tdt, offset, dev, scale=1.0):
    """A contiguous (R, N) view that starts ``offset`` elements into its
    buffer: 16-byte aligned only when offset * element size is."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(_np((n + offset,), seed, scale)).to(dev, tdt)
    return buf[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 6144), (4, 6144), (64, 2561),
                                   (33, 1025), (16, 4100), (8, 6143)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_rmsnorm_unaligned_and_ragged_rows(cuda, shape, offset, tdt):
    """x and gamma one element into their buffers, or rows that are not a
    whole number of 16-byte vectors, take the scalar kernel; aligned whole
    rows the one-pass kernel; both within the plain version's tolerance
    and the same bits on a repeated call."""
    R, N = shape
    x = _offset_view(shape, 26, tdt, offset, cuda, scale=2.0)
    g = _offset_view((N,), 27, torch.float32, offset, cuda)
    vector = offset == 0 and N * x.element_size() % 16 == 0
    assert (sfu.norm_plan(N, x.element_size(), sfu._aligned(x, g))
            > 0) == vector
    rtol, atol = (1e-4, 1e-5) if tdt == torch.float32 else _bf16_tol()
    for gamma in (None, g):
        got, again = rmsnorm_rows(x, gamma), rmsnorm_rows(x, gamma)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(),
                                   ref.rmsnorm_rows(x, gamma).float(),
                                   rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1032, 2560, 6144, 8192, 16384])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_rmsnorm_one_pass_and_scalar_kernels(cuda, N, tdt):
    """The one-pass kernel at the plan's threads (none for a row too wide
    for it) and the scalar block kernel on the same aligned rows, an odd
    row count, both within the plain version's tolerance."""
    x = torch.from_numpy(_np((37, N), 28, scale=2.0)).to(cuda, tdt)
    g = torch.from_numpy(_np((N,), 29)).to(cuda)
    threads = sfu.norm_plan(N, x.element_size(), True)
    assert (threads > 0) == (N * x.element_size() // 16
                             <= sfu.ROW_VPT * sfu.MAX_THREADS)
    rtol, atol = (1e-4, 1e-5) if tdt == torch.float32 else _bf16_tol()
    for t in {threads, 0}:
        out = torch.empty_like(x)
        sfu._launch_rmsnorm(x, g, 1e-6, out, t)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(),
                                   ref.rmsnorm_rows(x, g).float(),
                                   rtol=rtol, atol=atol)


# layernorm rows: the DORA path's (BERT-L 512 x 768, DeiT-L 197 x 768,
# DeiT-S 197 x 384, BERT-S 32 x 256) and nemotron-4-15b's prefill and
# decode rows (d_model 6144)
LN_ROWS = [(512, 768), (197, 768), (197, 384), (32, 256), (2048, 6144),
           (4, 6144)]
# softmax rows: the DORA path's (BERT-L, DeiT, BERT-S) and a row past the
# warp kernel's 1,024
SM_ROWS = [(512, 512), (197, 197), (32, 32), (3, 1025)]
# unaligned and ragged rows, each at offsets 0 and 1
LN_ODD = [(2048, 6144), (64, 2561), (8, 6143), (197, 768), (33, 1025)]


def _ln_forms(N, seed, dev, offset=0):
    g = _offset_view((N,), seed, torch.float32, offset, dev)
    b = _offset_view((N,), seed + 1, torch.float32, offset, dev)
    return [(None, None), (g, None), (None, b), (g, b)]


def _ln_tol(tdt):
    return (1e-4, 1e-5) if tdt == torch.float32 else _bf16_tol()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SFU_SHAPES + LN_ROWS)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_layernorm_matches_plain(cuda, shape, tdt):
    """fp32 and bf16 rows, with and without gamma and beta (fp32): one
    launch a call, x's dtype out, within the plain version's tolerance
    (bf16: one ulp) and the same bits on a repeated call."""
    x = torch.from_numpy(_np(shape, 31, scale=2.0)).to(cuda, tdt)
    rtol, atol = _ln_tol(tdt)
    for gamma, beta in _ln_forms(shape[1], 32, cuda):
        before = layernorm_rows.launches
        got, again = layernorm_rows(x, gamma, beta), layernorm_rows(x, gamma,
                                                                    beta)
        torch.cuda.synchronize()
        assert layernorm_rows.launches == before + 2 and got.dtype == tdt
        assert torch.equal(got, again)
        torch.testing.assert_close(
            got.float(), ref.layernorm_rows(x, gamma, beta).float(),
            rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LN_ODD)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_layernorm_unaligned_and_ragged_rows(cuda, shape, offset, tdt):
    """x, gamma and beta one element into their buffers, or rows of no
    whole number of 16-byte vectors, take scalar loads (the warp kernel's
    up to 1,024 wide, else the block kernel); aligned whole rows 16-byte
    loads; all within the plain version's tolerance."""
    R, N = shape
    x = _offset_view(shape, 33, tdt, offset, cuda, scale=2.0)
    forms = _ln_forms(N, 34, cuda, offset)
    whole = offset == 0 and N * x.element_size() % 16 == 0
    aligned = sfu._aligned(x, *forms[-1])
    assert (sfu.norm_plan(N, x.element_size(), aligned) > 0) == (
        whole and N > sfu.WARP_ROW_MAX)
    assert sfu.warp_plan(N, x.element_size(), aligned)[1] == (
        whole and N <= sfu.WARP_ROW_MAX)
    rtol, atol = _ln_tol(tdt)
    for gamma, beta in forms:
        got = layernorm_rows(x, gamma, beta)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.float(), ref.layernorm_rows(x, gamma, beta).float(),
            rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LN_ROWS + [(37, 1032), (5, 1000)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_layernorm_one_pass_and_block_kernels(cuda, shape, tdt):
    """The kernel of the plan (one-pass or warp) and the block kernel from
    before the redesign on the same rows, gamma and beta, both within the
    plain version's tolerance."""
    R, N = shape
    x = torch.from_numpy(_np(shape, 35, scale=2.0)).to(cuda, tdt)
    g, b = _ln_forms(N, 36, cuda)[-1]
    esize = x.element_size()
    plans = {(sfu.norm_plan(N, esize, True), *sfu.warp_plan(N, esize, True)),
             (0, 0, False)}
    assert len(plans) == 2
    rtol, atol = _ln_tol(tdt)
    want = ref.layernorm_rows(x, g, b).float()
    for plan in plans:
        out = torch.empty_like(x)
        sfu._launch_layernorm(x, g, b, 1e-5, out, *plan)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SFU_SHAPES + SM_ROWS)
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_softmax_warp_and_block_kernels(cuda, shape, offset):
    """The softmax of the plan (the warp kernel up to 1,024 wide, float4
    slots for aligned whole vectors, scalar ones for a view one element
    into its buffer or a ragged row; the block kernel past it) and the
    block kernel from before the redesign, within rtol 1e-5 / atol 1e-6 of
    the plain version; a repeated call gives the same bits."""
    x = _offset_view(shape, 37, torch.float32, offset, cuda, scale=3.0)
    slots, vector = sfu.warp_plan(shape[1], 4, sfu._aligned(x))
    assert vector == (offset == 0 and shape[1] % 4 == 0 and slots > 0)
    want = ref.softmax_rows(x)
    before = softmax_rows.launches
    got, again = softmax_rows(x), softmax_rows(x)
    out = torch.empty_like(x)
    sfu._launch_softmax(x, out, 0, False)
    torch.cuda.synchronize()
    assert softmax_rows.launches == before + 2 and torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 1001, 4096, 512 * 3072 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_act_ragged_and_unaligned(cuda, n, offset):
    """Every activation where n % 4 != 0 (the last block's scalar tail)
    and on a view one element into its buffer (the scalar kernel), and
    the scalar kernel on aligned operands too, within rtol 1e-5 / atol
    1e-6 of the plain version; a repeated call gives the same bits."""
    x = _offset_view((1, n), 30, torch.float32, offset, cuda, scale=3.0)
    assert sfu._aligned(x) == (offset == 0)
    for act in ACTIVATIONS:
        want = ref.ACT_FN[act](x)
        got, again = act_rows(x, act), act_rows(x, act)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        out = torch.empty_like(x)
        sfu._launch_act(x, out, act, False)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


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


def _qkv(shape, seed, cuda, tdt, cache=None):
    """q (B, Hq, Sq, D) and k, v of ``cache`` rows (default Skv), NaN past
    Skv: the kernels must never read there."""
    B, Hq, Hkv, Sq, Skv, D = shape
    rows = cache or Skv
    q = torch.from_numpy(_np((B, Hq, Sq, D), seed)).to(cuda, tdt)
    k = torch.from_numpy(_np((B, Hkv, rows, D), seed + 1)).to(cuda, tdt)
    v = torch.from_numpy(_np((B, Hkv, rows, D), seed + 2)).to(cuda, tdt)
    k[:, :, Skv:] = float("nan")
    v[:, :, Skv:] = float("nan")
    return q, k, v


def _attn_close(got, q, k, v, causal, skv, tdt):
    """tests/test_kernels.py's tolerances: fp32 1e-4 / 2e-5, bf16 3e-2."""
    rtol, atol = (1e-4, 2e-5) if tdt == torch.float32 else (3e-2, 3e-2)
    want = ref.mha_attention(q, k, v, causal=causal, kv_len=skv)
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [37, 200, 384, 512])
@pytest.mark.parametrize("cached", [0, 29])
def test_cuda_flash_attention_bf16_prefill_at_qwen3_4b(cuda, sq, cached):
    """The tensor-core kernel at qwen3-4b's widths (32 query heads over 8 KV
    heads of 128) and the served prompt lengths, causal, with ``cached``
    more keys than queries (offset Skv - Sq), read from a longer cache."""
    skv = sq + cached
    q, k, v = _qkv((4, 32, 8, sq, skv, 128), 60, cuda, torch.bfloat16,
                   cache=skv + 19)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, kv_len=skv)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _attn_close(got, q, k, v, True, skv, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_bf16_prefill_head_dims(cuda, d, causal):
    """Every head width of the tensor-core kernel, ragged query and key
    tiles, Skv > Sq."""
    q, k, v = _qkv((2, 6, 2, 100, 130, d), 63, cuda, torch.bfloat16)
    _attn_close(flash_attention(q, k, v, causal=causal), q, k, v, causal,
                130, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("skv", [1, 63, 64, 65, 540, 1024])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_split_kv_decode(cuda, skv, tdt):
    """qwen3-4b decode over the first ``skv`` rows of a 1024-row cache, NaN
    past them: one split up to 64 rows (no combine), several past."""
    q, k, v = _qkv((4, 32, 8, 1, skv, 128), 66, cuda, tdt, cache=1024)
    for causal in (False, True):
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal, kv_len=skv)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        _attn_close(got, q, k, v, causal, skv, tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 1, 1, 300, 16),
                                   (1, 4, 1, 1, 300, 32),
                                   (1, 4, 1, 1, 300, 64),
                                   (2, 8, 2, 4, 100, 64),
                                   (1, 16, 1, 1, 200, 128)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_decode_head_dims_and_groups(cuda, shape, tdt):
    """The decode path at every head width and at 16 query rows a block
    (4 causal queries x 4 heads, and 1 query x 16 heads)."""
    q, k, v = _qkv(shape, 69, cuda, tdt, cache=shape[4] + 7)
    for causal in (False, True):
        got = flash_attention(q, k, v, causal=causal, kv_len=shape[4])
        torch.cuda.synchronize()
        _attn_close(got, q, k, v, causal, shape[4], tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 1, 40, 24, 32),
                                   (1, 2, 1, 8, 4, 32)],
                         ids=["prefill", "decode"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_empty_rows_give_zero_on_both_paths(cuda, shape,
                                                                 tdt):
    """Causal with Sq > Skv: the first Sq - Skv rows see no key and give 0,
    in the prefill kernels (bf16 on the tensor cores) and the decode path."""
    q, k, v = _qkv(shape, 72, cuda, tdt)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    empty = shape[3] - shape[4]
    assert torch.equal(got[:, :, :empty], torch.zeros_like(got[:, :, :empty]))
    _attn_close(got, q, k, v, True, shape[4], tdt)


# (B, S, H, P, G, N): the reference's sweep (tests/test_kernels.py), its
# tail case S = 100, G > 1 with a tail, then mamba2-2.7b's prefill and
# two short prompts at its widths (80 heads of 64, state 128, one group),
# a 2,048-token prompt at its widths (16 chunks in series)
# and two state groups at model widths
SSD_SHAPES = [(2, 128, 4, 16, 2, 8), (1, 64, 2, 8, 1, 4),
              (2, 256, 8, 32, 2, 16), (1, 100, 2, 8, 1, 4),
              (2, 77, 8, 32, 4, 16), (4, 512, 80, 64, 1, 128),
              (2, 48, 80, 64, 1, 128), (2, 37, 80, 64, 1, 128),
              (1, 2048, 80, 64, 1, 128), (1, 256, 16, 64, 2, 128)]


def _ssd_inputs(shape, seed, cuda, tdt):
    """x ~ N(0, 1), b and c ~ N(0, 0.3²) in ``tdt``; a fp32 as mamba2
    makes it, -exp(A_log) dt with A_log's 1..16 over the heads and dt
    in [0.005, 0.1], so the last heads decay by up to e^-1.6 a step."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.005, 0.1, size=(B, S, H))
    a = -np.linspace(1.0, 16.0, H)[None, None] * dt
    x = torch.from_numpy(_np((B, S, H, P), seed + 1)).to(cuda, tdt)
    b = torch.from_numpy(_np((B, S, G, N), seed + 2, 0.3)).to(cuda, tdt)
    c = torch.from_numpy(_np((B, S, G, N), seed + 3, 0.3)).to(cuda, tdt)
    return x, torch.from_numpy(a.astype(np.float32)).to(cuda), b, c


def _ssd_close(got, want, tdt):
    """y: fp32 to reordered fp32 sums (1e-4); bf16 to those sums plus one
    bf16 ulp: the plain version computes in fp32 and rounds once, the
    kernel's tensor-core products take each fp32 operand as a bf16 high
    and low part, about fp32 sums again, and round y once (where terms of
    order 1 cancel to 1e-4, the fp32 difference outweighs the ulp;
    tests/test_torch_ssd.py shows one rounding of an operand failing
    this); the state is fp32 either way."""
    rtol, atol = (1e-4, 1e-4) if tdt == torch.float32 else (2 ** -7, 1e-4)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("chunk", [32, "model"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_cuda_ssd_matches_plain(cuda, shape, chunk, tdt, with_init):
    """Kernel against ``ref.ssd_plain`` (the chunked algorithm when S is
    a multiple of the chunk and longer, else the recurrence), in y and
    in the final state; ``chunk="model"`` is the SSM block's
    min(128, max(16, S))."""
    B, S, H, P, G, N = shape
    chunk = min(128, max(16, S)) if chunk == "model" else chunk
    x, a, b, c = _ssd_inputs(shape, 40, cuda, tdt)
    init = torch.from_numpy(_np((B, H, P, N), 45)).to(cuda) \
        if with_init else None
    before = ssd.launches
    got = ssd(x, a, b, c, chunk=chunk, initial_state=init)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    _ssd_close(got, ref.ssd_plain(x, a, b, c, chunk=chunk,
                                  initial_state=init), tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ssd_reads_strided_views_and_nothing_past_s(cuda, tdt):
    """x, a, b, c as views of wider buffers whose positions past S hold
    NaN, and b, c as slices of one (B, S, conv_dim) tensor as the SSM
    block hands them over: nothing past S may leak into y or the state."""
    B, S, H, P, G, N = 2, 100, 8, 32, 2, 16
    x, a, b, c = _ssd_inputs((B, S, H, P, G, N), 50, cuda, tdt)
    pad = 28
    xb = torch.full((B, S + pad, H, P), float("nan"), device=cuda, dtype=tdt)
    ab = torch.full((B, S + pad, H), float("nan"), device=cuda)
    bc = torch.full((B, S + pad, 3 * G * N), float("nan"), device=cuda,
                    dtype=tdt)
    xb[:, :S], ab[:, :S] = x, a
    bc[:, :S, G * N:2 * G * N] = b.reshape(B, S, G * N)
    bc[:, :S, 2 * G * N:] = c.reshape(B, S, G * N)
    bv = bc[:, :S, G * N:2 * G * N].reshape(B, S, G, N)
    cv = bc[:, :S, 2 * G * N:].reshape(B, S, G, N)
    assert not bv.is_contiguous() and not xb[:, :S].is_contiguous()
    got = ssd(xb[:, :S], ab[:, :S], bv, cv, chunk=64)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()
    _ssd_close(got, ref.ssd_plain(x, a, b, c, chunk=64), tdt)


# whisper-medium (16 heads of 64, no GQA) over 1,500 encoder frames, batch
# 4: the encoder's self-attention, the decoder's cross-attention prefill
# of a 64-token prompt and its cross decode; then a ragged non-causal
# shape whose Skv is no multiple of the 64-key tile
WHISPER_ATTN = [(4, 16, 16, 1500, 1500, 64), (4, 16, 16, 64, 1500, 64),
                (4, 16, 16, 1, 1500, 64), (2, 6, 2, 77, 1001, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WHISPER_ATTN,
                         ids=["encoder", "cross_prefill", "cross_decode",
                              "ragged"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_non_causal_at_whisper(cuda, shape, tdt):
    """Non-causal attention walks every KV tile, so the last, partial one
    (1,500 = 23 x 64 + 28 keys) decides each row's softmax; with Sq < Skv
    the causal offset must not cut the keys.  The caches hold NaN past
    Skv, which the kernels must never read; decode reads a cache whose
    stride is its kv_len."""
    q, k, v = _qkv(shape, 75, cuda, tdt, cache=shape[4] + 5)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False, kv_len=shape[4])
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _attn_close(got, q, k, v, False, shape[4], tdt)
    q, k, v = _qkv(shape, 78, cuda, tdt)
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _attn_close(got, q, k, v, False, shape[4], tdt)


# qwen2-vl-2b's rmsnorm rows (d_model 1536): prefill of 4 x 512 tokens and
# decode of 4; whisper-medium's layernorm rows (d_model 1024): the
# encoder's 4 x 1,500 frames, the decoder's 4 x 64 prompt and 4 tokens
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 1536), (4, 1536)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_rmsnorm_at_qwen2_vl(cuda, shape, tdt):
    x = torch.from_numpy(_np(shape, 81, scale=2.0)).to(cuda, tdt)
    g = torch.from_numpy(_np((shape[1],), 82)).to(cuda)
    rtol, atol = (1e-4, 1e-5) if tdt == torch.float32 else _bf16_tol()
    for gamma in (None, g):
        got = rmsnorm_rows(x, gamma)
        torch.cuda.synchronize()
        assert got.dtype == tdt
        torch.testing.assert_close(got.float(),
                                   ref.rmsnorm_rows(x, gamma).float(),
                                   rtol=rtol, atol=atol)
        assert torch.equal(got, rmsnorm_rows(x, gamma))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6000, 1024), (256, 1024), (4, 1024)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_layernorm_at_whisper(cuda, shape, tdt):
    x = torch.from_numpy(_np(shape, 83, scale=2.0)).to(cuda, tdt)
    rtol, atol = _ln_tol(tdt)
    for gamma, beta in _ln_forms(shape[1], 84, cuda):
        got = layernorm_rows(x, gamma, beta)
        torch.cuda.synchronize()
        assert got.dtype == tdt
        torch.testing.assert_close(
            got.float(), ref.layernorm_rows(x, gamma, beta).float(),
            rtol=rtol, atol=atol)


# The MoE archs' shapes as chip_smoke.py serves them (4 requests of up to
# 512 tokens): rmsnorm rows of llama4-maverick (d 5120) and jamba (d 8192,
# and its gated norm over 16,384: ``norm_plan`` gives exactly MAX_THREADS
# there in bf16), layernorm rows of dbrx (d 6144), prefill and decode
@pytest.mark.cuda
@pytest.mark.parametrize("kernel, shape", [
    ("rmsnorm", (2048, 5120)), ("rmsnorm", (4, 5120)),
    ("rmsnorm", (2048, 8192)), ("rmsnorm", (4, 8192)),
    ("rmsnorm", (2048, 16384)), ("rmsnorm", (4, 16384)),
    ("layernorm", (2048, 6144)), ("layernorm", (4, 6144))])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_norms_at_the_moe_archs(cuda, kernel, shape, tdt):
    if kernel == "rmsnorm":
        assert sfu.norm_plan(16384, 2, True) == sfu.MAX_THREADS
    x = torch.from_numpy(_np(shape, 91, scale=2.0)).to(cuda, tdt)
    g = torch.from_numpy(_np((shape[1],), 92)).to(cuda)
    b = torch.from_numpy(_np((shape[1],), 93)).to(cuda)
    rtol, atol = _ln_tol(tdt)
    forms = ([(None,), (g,)] if kernel == "rmsnorm"
             else [(None, None), (g, b)])
    fn, plain = ((rmsnorm_rows, ref.rmsnorm_rows) if kernel == "rmsnorm"
                 else (layernorm_rows, ref.layernorm_rows))
    for form in forms:
        got = fn(x, *form)
        torch.cuda.synchronize()
        assert got.dtype == tdt
        torch.testing.assert_close(got.float(), plain(x, *form).float(),
                                   rtol=rtol, atol=atol)
        assert torch.equal(got, fn(x, *form))


# GQA 5 (llama4-maverick: 40 query heads over 8) and GQA 8 (jamba: 64 over
# 8), head 128: the causal prefill of 4 x 512 tokens and decode over the
# served cache (543 of 1,024 rows)
@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(40, 8), (64, 8)], ids=["gqa5", "gqa8"])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_cuda_flash_attention_at_the_moe_archs(cuda, heads, phase):
    Hq, Hkv = heads
    if phase == "prefill":
        shape, cache, causal = (4, Hq, Hkv, 512, 512, 128), None, True
    else:
        shape, cache, causal = (4, Hq, Hkv, 1, 543, 128), 1024, False
    q, k, v = _qkv(shape, 94, cuda, torch.bfloat16, cache=cache)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_len=shape[4])
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _attn_close(got, q, k, v, causal, shape[4], torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ssd_at_jamba(cuda, tdt):
    """jamba-1.5-large's prefill: 256 SSD heads of 64 (mamba2 has 80),
    state 128, one group, 4 x 512 tokens, chunk 128."""
    shape = (4, 512, 256, 64, 1, 128)
    x, a, b, c = _ssd_inputs(shape, 95, cuda, tdt)
    got = ssd(x, a, b, c, chunk=128)
    torch.cuda.synchronize()
    _ssd_close(got, ref.ssd_plain(x, a, b, c, chunk=128), tdt)


# moe_fwd on the card: dbrx's published widths (d 6144, d_ff 10752, 16
# experts top-4) and a top-1 of 128 experts at narrow widths, prefill (4 x
# 512 tokens, one group a row) and decode (4 x 1)
@pytest.mark.cuda
@pytest.mark.parametrize("moe", ["dbrx", "top1of128"])
@pytest.mark.parametrize("S", [512, 1], ids=["prefill", "decode"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_moe_index_path_gives_the_one_hot_numbers(cuda, moe, S, tdt):
    """The index dispatch against the one-hot einsums on one route: the
    dispatched slots bit for bit, the kept shares equal, y within one
    rounding of max|y| (bf16: two ulps; fp32: 1e-5 relative, as cuBLAS
    sums the combine's K products in another order)."""
    cfg = get_config("dbrx-132b")
    if moe == "top1of128":
        cfg = dataclasses.replace(cfg, d_model=512, d_ff=1024,
                                  n_experts=128, top_k=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = layers.init_moe(cfg, gen, cuda, tdt)
    x = torch.from_numpy(_np((4, S, cfg.d_model), 96)).to(cuda, tdt)
    r = layers.moe_route(cfg, p, x)
    yi, di, xi = layers._moe_index(cfg, p, r)
    yo, do, xo = layers._moe_onehot(cfg, p, r)
    torch.cuda.synchronize()
    assert torch.equal(xi, xo) and torch.equal(di, do)
    scale = float(yo.float().abs().max())
    tol = (2 * 2.0 ** (np.floor(np.log2(scale)) - 7) if tdt == torch.bfloat16
           else 1e-5 * scale)
    assert float((yi.float() - yo.float()).abs().max()) <= tol
    assert r.cap == (1 if S == 1 else
                     int(np.ceil(S * cfg.top_k / cfg.n_experts * 1.25)))


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_moe_index_path_gradients_are_the_one_hot_gradients(cuda, tdt):
    """Autograd through the index path against the one-hot einsums' at
    dbrx's widths (d 6144, d_ff 10752, 16 experts top-4, 4 x 512 tokens),
    through y and the aux loss: the gradients of x, the router and the
    three expert leaves, fp32 within 1e-4 x max|g| (reordered fp32 sums,
    the backward kernels' tolerance), bf16 within a relative L2 of 2e-2;
    a second backward pass of the index path equal to the bit (the
    accumulating gather's backward sorts its indices and sums in
    order)."""
    cfg = get_config("dbrx-132b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = layers.init_moe(cfg, gen, cuda, tdt)
    x = torch.from_numpy(_np((4, 512, cfg.d_model), 97)).to(cuda, tdt)
    dy = torch.from_numpy(_np((4, 512, cfg.d_model), 98)).to(cuda, tdt)

    def grads(plain):
        leaves = [x.clone().requires_grad_()] + [
            t.detach().requires_grad_() for t in p.values()]
        y, aux = layers.moe_fwd(cfg, dict(zip(p, leaves[1:])), leaves[0],
                                plain=plain)
        return torch.autograd.grad((y.float() * dy.float()).sum() + aux,
                                   leaves)

    index = grads(False)
    again = grads(False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(index, again))
    del again
    for name, got, want in zip(["x", *p], index, grads(True)):
        assert float(want.float().abs().max()) > 0, name
        _grad_close(got, want, tdt)


# ------------------------------------------------------ training (backward)
# Backward kernels against autograd of the plain versions (the reference's
# models differentiate their jnp oracles; no Pallas kernel has a VJP):
# fp32 within 1e-4 * max|ref| per gradient; bf16 dx / dq / dk / dv within
# a relative L2 of 2e-2, dgamma (fp32 sums of bf16 products) within 1e-3.
# (rows, width, offset): the reference's SFU rows, qwen3-4b's training rows
# (norm1/norm2/final_norm 4 x 512 tokens of 2560, the q-norm 65,536 rows of
# 128 and the k-norm 16,384), a ragged width and an unaligned view (the
# block kernel's and the warp kernel's scalar loads)
RMS_BWD_ROWS = [(R, N, 0) for R, N in SFU_SHAPES] + [
    (2048, 2560, 0), (65536, 128, 0), (16384, 128, 0), (64, 2561, 0),
    (2048, 2560, 1), (33, 1000, 1)]
# the MoE archs' training rows (4 x 512 tokens): llama4-maverick's 5120,
# jamba-1.5-large's 8192 (the vector kernel) and its gated norm over
# 16,384 (past 10,240 bf16: the block kernel)
RMS_BWD_ROWS += [(2048, 5120, 0), (2048, 8192, 0), (2048, 16384, 0)]
# qwen2-vl-2b's training rows (1536) and internlm2-20b's (6144)
RMS_BWD_ROWS += [(2048, 1536, 0), (2048, 6144, 0)]
# the reference's attention sweep (causal and not, fp32), qwen3-4b's
# training attention (bf16, causal); then on the bf16 tensor-core kernels
# the same sweep, a causal case whose first 40 query rows see no key (Sq >
# Skv, both dtypes) and a ragged head-128 GQA-4 case with Sq != Skv
ATTN_EMPTY_ROWS = (1, 4, 2, 80, 40, 64)
ATTN_RAGGED_128 = (1, 8, 2, 100, 130, 128)
ATTN_BWD = [(s, c, torch.float32) for s in ATTN_SHAPES[:-1]
            for c in (True, False)] + [(ATTN_SHAPES[-1], True, torch.bfloat16)]
ATTN_BWD += [(s, c, torch.bfloat16)
             for s in ATTN_SHAPES[:-1] + [ATTN_EMPTY_ROWS, ATTN_RAGGED_128]
             for c in (True, False)] + [(ATTN_EMPTY_ROWS, True, torch.float32)]
# the MoE archs' training attention (bf16, causal, 4 x 512 tokens, head
# 128 over 8 kv heads): dbrx's GQA 6, llama4's GQA 5 and jamba's GQA 8, and
# a ragged GQA-5 case with Sq != Skv, both masks
ATTN_RAGGED_GQA5 = (1, 10, 2, 100, 130, 128)
ATTN_BWD += [((4, hq, 8, 512, 512, 128), True, torch.bfloat16)
             for hq in (48, 40, 64)] + [
    (ATTN_RAGGED_GQA5, c, torch.bfloat16) for c in (True, False)]
# the dense archs' training attention (causal, 4 x 512 tokens, head 128)
# that no other path reaches, both dtypes: qwen1.5-4b's 20 query heads over
# 20 kv heads (GQA 1) and qwen2-vl-2b's 12 over 2 (GQA 6)
ATTN_BWD += [((4, hq, hkv, 512, 512, 128), True, tdt)
             for hq, hkv in ((20, 20), (12, 2))
             for tdt in (torch.float32, torch.bfloat16)]


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _grad_close(got, want, tdt, bf16_rel=2e-2):
    if tdt == torch.float32:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
    else:
        assert got.dtype == want.dtype and _rel_l2(got, want) <= bf16_rel


def _view(shape, offset, seed, cuda, tdt, scale=1.0):
    n = int(np.prod(shape))
    buf = torch.from_numpy(_np((n + offset,), seed, scale)).to(cuda, tdt)
    return buf[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", RMS_BWD_ROWS, ids=str)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_gamma", [True, False], ids=["gamma", "plain"])
def test_cuda_rmsnorm_backward_matches_autograd_of_plain(cuda, rows, tdt,
                                                         with_gamma):
    R, N, offset = rows
    x = _view((R, N), offset, 100, cuda, tdt, 2.0)
    dy = _view((R, N), offset, 101, cuda, tdt)
    g = (1.0 + _view((N,), offset, 102, cuda, torch.float32, 0.2)
         if with_gamma else None)
    xr = x.detach().clone().requires_grad_()
    gr = g.detach().clone().requires_grad_() if with_gamma else None
    ref.rmsnorm_rows(xr, gr).backward(dy)
    xk = x.detach().requires_grad_()
    gk = g.detach().requires_grad_() if with_gamma else None
    before = (rmsnorm_rows.launches, sfu.rmsnorm_bwd.launches)
    out = rmsnorm_rows(xk, gk)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (rmsnorm_rows.launches, sfu.rmsnorm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out.grad_fn is not None and xk.grad.dtype == tdt
    _grad_close(xk.grad, xr.grad, tdt)
    if with_gamma:
        if tdt == torch.float32:
            _grad_close(gk.grad, gr.grad, tdt)
        else:
            assert _rel_l2(gk.grad, gr.grad) <= 1e-3
    # a replay gives the same bits (no atomics)
    rstd = ref.rmsnorm_rstd(x)
    first = sfu.rmsnorm_bwd(x, g, rstd, dy.contiguous())
    again = sfu.rmsnorm_bwd(x, g, rstd, dy.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0])
    assert with_gamma == (first[1] is not None)
    if with_gamma:
        assert torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_rmsnorm_backward_of_no_rows_gives_zero_dgamma(cuda, tdt):
    x = torch.empty((0, 2560), device=cuda, dtype=tdt)
    g = torch.ones(2560, device=cuda)
    before = sfu.rmsnorm_bwd.launches
    dx, dg = sfu.rmsnorm_bwd(x, g, torch.empty(0, device=cuda), x)
    assert dx.shape == x.shape and dg.shape == (2560,) and not dg.any()
    assert sfu.rmsnorm_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_BWD, ids=str)
def test_cuda_attention_backward_matches_autograd_of_plain(cuda, case):
    (B, Hq, Hkv, Sq, Skv, D), causal, tdt = case
    q = torch.from_numpy(_np((B, Hq, Sq, D), 110)).to(cuda, tdt)
    k = torch.from_numpy(_np((B, Hkv, Skv, D), 111)).to(cuda, tdt)
    v = torch.from_numpy(_np((B, Hkv, Skv, D), 112)).to(cuda, tdt)
    do = torch.from_numpy(_np((B, Hq, Sq, D), 113)).to(cuda, tdt)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.mha_attention(*leaves, causal=causal).backward(do)
    # the kernels directly (the decode-shaped cases too: the backward kernel
    # takes any shape; the autograd wrapper only the prefill's)
    out, lse = fa.attention_lse(q, k, v, causal=causal)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    for got, leaf, rep in zip(grads, leaves, again):
        _grad_close(got, leaf.grad, tdt)
        assert torch.equal(got, rep)
    _, lse_plain = ref.mha_attention_lse(q, k, v, causal=causal)
    assert float((lse - lse_plain).abs().max()) <= 1e-3
    if causal and Sq > Skv:     # rows that see no key get no gradient
        assert not grads[0][:, :, :Sq - Skv].any()


@pytest.mark.cuda
def test_cuda_attention_autograd_runs_the_backward_kernel(cuda):
    """qwen3-4b's training attention through the wrapper under autograd:
    one forward (with lse) and one backward launch, the gradients equal to
    the kernels called directly."""
    B, Hq, Hkv, S, D = 4, 32, 8, 512, 128
    q, k, v = (torch.from_numpy(_np(s, 120 + i)).to(cuda, torch.bfloat16)
               for i, s in enumerate(((B, Hq, S, D), (B, Hkv, S, D),
                                      (B, Hkv, S, D))))
    do = torch.from_numpy(_np((B, Hq, S, D), 123)).to(cuda, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, fa.flash_attention_bwd.launches)
    out = flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, fa.flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    o2, lse = fa.attention_lse(q, k, v, causal=True)
    want = fa.flash_attention_bwd(q, k, v, o2, lse, do, causal=True)
    assert torch.equal(out.detach(), o2)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


# layernorm's backward rows (rows, width, offset): the reference's SFU
# rows, whisper-medium's training rows (4 x 512 tokens of 1024: the vector
# kernel) and the same offset by one element (the warp kernel's scalar
# loads), nemotron-4-15b's (6144: the vector kernel), a ragged width (the
# block kernel), unaligned views (scalar loads), a row past the warp
# kernel's 1,024, and the vector kernel's 768 and 1,000
LN_BWD_ROWS = [(R, N, 0) for R, N in SFU_SHAPES] + [
    (2048, 1024, 0), (2048, 1024, 1), (2048, 6144, 0), (64, 2561, 0),
    (2048, 6144, 1), (197, 768, 1), (33, 1025, 0), (64, 1000, 0),
    (600, 768, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", LN_BWD_ROWS, ids=str)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("form", ["gamma_beta", "gamma", "beta", "plain"])
def test_cuda_layernorm_backward_matches_autograd_of_plain(cuda, rows, tdt,
                                                           form):
    """layernorm under autograd on the card: one forward (with mean and
    rstd) and one backward launch, dx within the backward limits of the
    plain version's autograd (fp32 1e-4 x max|ref|, bf16 rel L2 2e-2),
    dgamma and dbeta (fp32 sums in another order) within 1e-4 x max|ref|
    (fp32) or rel L2 1e-3 (bf16), and the same bits on a replay."""
    R, N, offset = rows
    x = _view((R, N), offset, 140, cuda, tdt, 2.0)
    dy = _view((R, N), offset, 141, cuda, tdt)
    g = 1.0 + _view((N,), offset, 142, cuda, torch.float32, 0.2) \
        if "gamma" in form else None
    bt = _view((N,), offset, 143, cuda, torch.float32, 0.2) \
        if "beta" in form else None
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in (x, g, bt)]
    ref.layernorm_rows(*leaves).backward(dy)
    kl = [None if t is None else t.detach().requires_grad_()
          for t in (x, g, bt)]
    before = (layernorm_rows.launches, sfu.layernorm_bwd.launches)
    out = layernorm_rows(*kl)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (layernorm_rows.launches, sfu.layernorm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out.grad_fn is not None and kl[0].grad.dtype == tdt
    _grad_close(kl[0].grad, leaves[0].grad, tdt)
    for k, w in zip(kl[1:], leaves[1:]):
        if k is None:
            continue
        if tdt == torch.float32:
            _grad_close(k.grad, w.grad, tdt)
        else:
            assert _rel_l2(k.grad, w.grad) <= 1e-3
    mean, rstd = ref.layernorm_stats(x)
    first = sfu.layernorm_bwd(x, g, bt, mean, rstd, dy.contiguous())
    again = sfu.layernorm_bwd(x, g, bt, mean, rstd, dy.contiguous())
    torch.cuda.synchronize()
    for f, a_, want in zip(first, again, (x, g, bt)):
        assert (f is None) == (want is None)
        if f is not None:
            assert torch.equal(f, a_)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_layernorm_backward_of_no_rows_gives_zero_sums(cuda, tdt):
    x = torch.empty((0, 1024), device=cuda, dtype=tdt)
    g = torch.ones(1024, device=cuda)
    before = sfu.layernorm_bwd.launches
    dx, dg, db = sfu.layernorm_bwd(x, g, g, torch.empty(0, device=cuda),
                                   torch.empty(0, device=cuda), x)
    assert dx.shape == x.shape and not dg.any() and not db.any()
    assert sfu.layernorm_bwd.launches == before


# ssd's backward: the forward's SSD_SHAPES sweep (chunk 32 and the SSM
# block's), and jamba's 256 heads
SSD_BWD_SHAPES = SSD_SHAPES + [(1, 128, 256, 64, 1, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES, ids=str)
@pytest.mark.parametrize("chunk", [32, "model"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_cuda_ssd_backward_matches_autograd_of_plain(cuda, shape, chunk, tdt,
                                                     with_init):
    """``ssd`` under autograd on the card (with a gradient into the final
    state where it starts from one): one forward and one backward launch;
    dx, da, db, dc and the initial state's gradient against autograd of
    ``ref.ssd_plain`` (fp32 within 1e-4 x max|ref|, bf16 rel L2 2e-2), and
    the backward kernels twice on the saved scratch give the same bits."""
    B, S, H, P, G, N = shape
    chunk = min(128, max(16, S)) if chunk == "model" else chunk
    x, a, b, c = _ssd_inputs(shape, 150, cuda, tdt)
    dy = torch.from_numpy(_np((B, S, H, P), 155)).to(cuda, tdt)
    init = torch.from_numpy(_np((B, H, P, N), 156)).to(cuda) \
        if with_init else None
    dfin = torch.from_numpy(_np((B, H, P, N), 157)).to(cuda) \
        if with_init else None
    ops = [t for t in (x, a, b, c, init)]
    plain = [None if t is None else t.detach().clone().requires_grad_()
             for t in ops]
    y, fin = ref.ssd_plain(*plain[:4], chunk=chunk, initial_state=plain[4])
    torch.autograd.backward([y, fin] if with_init else [y],
                            [dy, dfin] if with_init else [dy])
    kern = [None if t is None else t.detach().requires_grad_() for t in ops]
    before = (ssd.launches, ssd_mod.ssd_bwd.launches)
    y2, fin2 = ssd(*kern[:4], chunk=chunk, initial_state=kern[4])
    torch.autograd.backward([y2, fin2] if with_init else [y2],
                            [dy, dfin] if with_init else [dy])
    torch.cuda.synchronize()
    assert (ssd.launches, ssd_mod.ssd_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for k, w in zip(kern, plain):
        if k is not None:
            assert k.grad.dtype == w.grad.dtype
            _grad_close(k.grad, w.grad, k.grad.dtype)
    _, _, states = ssd_mod.ssd_states(x, a, b, c, chunk=chunk,
                                      initial_state=init)
    runs = [ssd_mod.ssd_bwd(x, a, b, c, dy, chunk=chunk, initial_state=init,
                            dfinal=dfin, states=states) for _ in range(2)]
    torch.cuda.synchronize()
    assert (runs[0][4] is None) == (init is None)
    for f, r in zip(*runs):
        if f is not None:
            assert torch.equal(f, r)


# the bf16 kernels' other paths, (B, S, H, P, G, N, chunk): a chunk under
# 16 (one tile, rows past the chunk zero); a ragged last chunk (100 = 48 +
# 48 + 4); P < 64 and N < 128 in whole 16-byte vectors (zero columns) and
# not (element loads); G > 1 with head blocks over each group's 12 heads
SSD_BWD_PATHS = [(2, 40, 4, 16, 2, 8, 8), (1, 100, 4, 64, 1, 128, 48),
                 (1, 64, 6, 40, 2, 72, 32), (1, 64, 4, 20, 2, 36, 64),
                 (1, 256, 48, 64, 4, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_PATHS, ids=str)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ssd_backward_paths_match_autograd_of_plain(cuda, case, tdt):
    """From an initial state with a gradient into the final state: the
    backward kernels on the saved scratch against autograd of
    ``ref.ssd_plain`` (fp32 within 1e-4 x max|ref|, bf16 rel L2 2e-2),
    the same bits on a replay."""
    *shape, chunk = case
    B, S, H, P, G, N = shape
    x, a, b, c = _ssd_inputs(shape, 170, cuda, tdt)
    dy = torch.from_numpy(_np((B, S, H, P), 171)).to(cuda, tdt)
    init = torch.from_numpy(_np((B, H, P, N), 172)).to(cuda)
    dfin = torch.from_numpy(_np((B, H, P, N), 173)).to(cuda)
    plain = [t.detach().clone().requires_grad_() for t in (x, a, b, c, init)]
    y, fin = ref.ssd_plain(*plain[:4], chunk=chunk, initial_state=plain[4])
    torch.autograd.backward([y, fin], [dy, dfin])
    _, _, states = ssd_mod.ssd_states(x, a, b, c, chunk=chunk,
                                      initial_state=init)
    before = ssd_mod.ssd_bwd.launches
    runs = [ssd_mod.ssd_bwd(x, a, b, c, dy, chunk=chunk, initial_state=init,
                            dfinal=dfin, states=states) for _ in range(2)]
    torch.cuda.synchronize()
    assert ssd_mod.ssd_bwd.launches == before + 2
    for got, again, leaf in zip(*runs, plain):
        assert torch.equal(got, again)
        _grad_close(got, leaf.grad, got.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ssd_backward_reads_views_off_16_bytes(cuda, tdt):
    """b and c as slices of one (B, S, 1 + 2 G N) tensor one element off
    16 bytes (x and dy too): the kernels stage them by element loads; the
    gradients equal the plain version's, the same bits on a replay."""
    B, S, H, P, G, N = 2, 100, 8, 32, 2, 16
    x, a, b, c = _ssd_inputs((B, S, H, P, G, N), 180, cuda, tdt)
    dy = torch.from_numpy(_np((B, S, H, P), 181)).to(cuda, tdt)
    pad = torch.zeros((B, S, 1), device=cuda, dtype=tdt)
    bc = torch.cat([pad, b.reshape(B, S, G * N), c.reshape(B, S, G * N)], -1)
    bv = bc[..., 1:1 + G * N].reshape(B, S, G, N)
    cv = bc[..., 1 + G * N:].reshape(B, S, G, N)
    xv = _view((B, S, H, P), 1, 182, cuda, tdt)
    xv.copy_(x)
    assert bv.data_ptr() % 16 and xv.data_ptr() % 16
    plain = [t.detach().clone().requires_grad_() for t in (x, a, b, c)]
    ref.ssd_plain(*plain, chunk=32)[0].backward(dy)
    _, _, states = ssd_mod.ssd_states(xv, a, bv, cv, chunk=32)
    runs = [ssd_mod.ssd_bwd(xv, a, bv, cv, dy, chunk=32, states=states)
            for _ in range(2)]
    torch.cuda.synchronize()
    for got, again, leaf in zip(*runs, plain):
        assert torch.equal(got, again)
        _grad_close(got, leaf.grad, got.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ssd_backward_reads_strided_views(cuda, tdt):
    """b and c as slices of one (B, S, conv_dim) tensor that requires grad,
    as the SSM block hands them over: their gradients come back through
    the views into it, equal to the plain version's."""
    B, S, H, P, G, N = 2, 100, 8, 32, 2, 16
    x, a, b, c = _ssd_inputs((B, S, H, P, G, N), 160, cuda, tdt)
    dy = torch.from_numpy(_np((B, S, H, P), 161)).to(cuda, tdt)
    bc = torch.cat([b.reshape(B, S, G * N), c.reshape(B, S, G * N)], -1)
    grads = []
    for fn in (ref.ssd_plain, ssd):
        xl, bcl = x.detach().requires_grad_(), bc.detach().requires_grad_()
        bv = bcl[..., :G * N].reshape(B, S, G, N)
        cv = bcl[..., G * N:].reshape(B, S, G, N)
        assert not bv.is_contiguous()
        fn(xl, a, bv, cv, chunk=64)[0].backward(dy)
        grads.append((xl.grad, bcl.grad))
    torch.cuda.synchronize()
    for k, w in zip(grads[1], grads[0]):
        _grad_close(k, w, tdt)


def _c5_calls(cuda):
    """Each kernel without a backward (C.5), called on CUDA tensors that
    require grad: name -> a call."""
    x = torch.from_numpy(_np((8, 256), 130)).to(cuda).requires_grad_()
    w = torch.from_numpy(_np((256, 64), 133)).to(cuda).requires_grad_()
    q = torch.from_numpy(_np((1, 4, 1, 64), 134)).to(cuda).requires_grad_()
    kv = torch.from_numpy(_np((1, 4, 32, 64), 135)).to(cuda)
    q64 = torch.from_numpy(_np((1, 4, 64, 64), 136)).to(cuda).requires_grad_()
    kv64 = torch.from_numpy(_np((1, 4, 64, 64), 137)).to(cuda)
    return {
        "softmax_rows": lambda: softmax_rows(x),
        "act_rows": lambda: act_rows(x, "gelu"),
        "flex_gemm": lambda: flex_gemm(x, w),
        "flash_attention decode shape": lambda: flash_attention(
            q, kv, kv, causal=True),
        "flash_attention kv_len": lambda: flash_attention(
            q64, kv64, kv64, causal=False, kv_len=32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["softmax_rows", "act_rows", "flex_gemm",
                                  "flash_attention decode shape",
                                  "flash_attention kv_len"])
def test_cuda_kernels_without_a_backward_raise_under_autograd(cuda, name):
    call = _c5_calls(cuda)[name]
    with pytest.raises(RuntimeError, match="A.5b"):
        call()
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is None and torch.isfinite(out).all()


# the reduced configs' launches a step (no remat there): {kernel: count}
# from n layers (encoder layers for whisper, decoder ones after)
TRAIN_LAUNCHES = {
    "qwen3-4b": lambda cfg: {
        "rmsnorm_rows": 4 * cfg.n_layers + 1, "rmsnorm_bwd": 4 * cfg.n_layers + 1,
        "flash_attention": cfg.n_layers, "flash_attention_bwd": cfg.n_layers},
    "whisper-medium": lambda cfg: {
        "layernorm_rows": 2 * cfg.encoder_layers + 3 * cfg.n_layers + 2,
        "layernorm_bwd": 2 * cfg.encoder_layers + 3 * cfg.n_layers + 2,
        "flash_attention": cfg.encoder_layers + 2 * cfg.n_layers,
        "flash_attention_bwd": cfg.encoder_layers + 2 * cfg.n_layers},
    "mamba2-2.7b": lambda cfg: {
        "rmsnorm_rows": 2 * cfg.n_layers + 1, "rmsnorm_bwd": 2 * cfg.n_layers + 1,
        "ssd": cfg.n_layers, "ssd_bwd": cfg.n_layers},
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(TRAIN_LAUNCHES))
def test_cuda_trainer_trains_reduced_qwen3_and_replays_a_fault(cuda,
                                                               tmp_path,
                                                               arch):
    """``Trainer`` on the card at the reduced config (fp32) of qwen3-4b,
    whisper-medium and mamba2-2.7b: the loss falls as on the CPU
    (tests/test_torch_train.py), every step goes through the backward
    kernels (one call of each a forward call: no remat in the reduced
    configs), and a run with a fault injected and resumed from its
    checkpoint replays the uninterrupted losses."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.train import TrainOptions, Trainer
    cfg = get_config(arch, reduced=True)
    shape = ShapeSpec("t", 64, 8, "train")
    fns = {"rmsnorm_rows": rmsnorm_rows, "rmsnorm_bwd": sfu.rmsnorm_bwd,
           "layernorm_rows": layernorm_rows,
           "layernorm_bwd": sfu.layernorm_bwd,
           "flash_attention": flash_attention,
           "flash_attention_bwd": fa.flash_attention_bwd, "ssd": ssd,
           "ssd_bwd": ssd_mod.ssd_bwd}
    before = {k: f.launches for k, f in fns.items()}
    tr = Trainer(cfg, shape, device=cuda, options=TrainOptions(
        steps=40, ckpt_every=10, ckpt_dir=str(tmp_path / "a"),
        log_every=1000))
    tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    want = {k: 40 * n for k, n in TRAIN_LAUNCHES[arch](cfg).items()}
    assert {k: f.launches - before[k] for k, f in fns.items()} == \
        dict.fromkeys(fns, 0) | want
    faulty = Trainer(cfg, shape, device=cuda, options=TrainOptions(
        steps=40, ckpt_every=10, ckpt_dir=str(tmp_path / "b"),
        fail_at_step=25, log_every=1000))
    faulty.run()
    assert faulty.failures == 1
    replayed = {m["step"]: m["loss"] for m in faulty.metrics_log}
    for m in tr.metrics_log:
        assert replayed[m["step"]] == pytest.approx(m["loss"], rel=1e-6)


# ------------------------------------------------------ the one-device mesh

@pytest.fixture
def card_mesh(cuda):
    """The card's (data 1, model 1) mesh over a world of one (NCCL)."""
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh()


def _on_mesh(t, mesh, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False)


def _op_cases(dev, tdt):
    """(name, fn of (plain, to_mesh), the kernel wrapper it launches)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops
    rows, rep = [Shard(0), Replicate()], [Replicate(), Replicate()]
    heads = [Shard(0), Shard(1)]
    x = torch.from_numpy(_np((4, 64, 256), 1)).to(dev, tdt)
    g = torch.from_numpy(_np((256,), 2)).to(dev) + 1
    b = torch.from_numpy(_np((256,), 3)).to(dev)
    q = torch.from_numpy(_np((4, 8, 64, 128), 4)).to(dev, tdt)
    k = torch.from_numpy(_np((4, 2, 64, 128), 5)).to(dev, tdt)
    v = torch.from_numpy(_np((4, 2, 64, 128), 6)).to(dev, tdt)
    xs = torch.from_numpy(_np((2, 128, 8, 64), 7)).to(dev, tdt)
    a = -torch.from_numpy(np.abs(_np((2, 128, 8), 8)) * 0.1).to(dev)
    bs = torch.from_numpy(_np((2, 128, 1, 64), 9)).to(dev, tdt)
    cs = torch.from_numpy(_np((2, 128, 1, 64), 10)).to(dev, tdt)
    return [
        ("rmsnorm", lambda plain, m: ops.rmsnorm(m(x, rows), m(g, rep),
                                                 plain=plain), rmsnorm_rows),
        ("layernorm", lambda plain, m: ops.layernorm(
            m(x, rows), m(g, rep), m(b, rep), plain=plain), layernorm_rows),
        ("attention", lambda plain, m: ops.attention(
            m(q, heads), m(k, heads), m(v, heads), causal=True,
            plain=plain), flash_attention),
        ("decode", lambda plain, m: ops.attention(
            m(q[:, :, :1].contiguous(), heads), m(k, heads), m(v, heads),
            causal=False, kv_len=40, plain=plain), flash_attention),
        ("ssd", lambda plain, m: ops.ssd(
            m(xs, [Shard(0), Shard(2)]), m(a, [Shard(0), Shard(2)]),
            m(bs, [Shard(0), Replicate()]), m(cs, [Shard(0), Replicate()]),
            chunk=64, plain=plain)[0], ssd),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rmsnorm", "layernorm", "attention",
                                  "decode", "ssd"])
@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ops_on_the_one_device_mesh_equal_plain_tensors(
        card_mesh, case, plain, tdt):
    """``kernels.ops``' four entry points on (1, 1)-mesh DTensors hand the
    kernel (or the plain version) this rank's tensors: the numbers of the
    same call on plain tensors, bit for bit, and one launch a call."""
    from torch.distributed.tensor import DTensor
    name, fn, wrapper = next(c for c in _op_cases(torch.device("cuda"), tdt)
                             if c[0] == case)
    want = fn(plain, lambda t, pl: t)
    before = wrapper.launches
    got = fn(plain, lambda t, pl: _on_mesh(t, card_mesh, pl))
    assert isinstance(got, DTensor)
    assert wrapper.launches - before == (0 if plain else 1)
    assert torch.equal(got.to_local(), want)


@pytest.mark.cuda
def test_cuda_kernel_wrappers_refuse_a_dtensor(card_mesh):
    from torch.distributed.tensor import Replicate
    x = torch.ones(4, 256, device="cuda")
    xd = _on_mesh(x, card_mesh, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        rmsnorm_rows(xd)
    q = _on_mesh(torch.ones(1, 2, 8, 64, device="cuda"), card_mesh,
                 [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["none", "bias_gelu"])
def test_cuda_ops_linear_launches_flex_gemm_once(cuda, epilogue):
    """``ops.linear`` flattens (2, 5, 64) rows into one ``flex_gemm``
    launch and matches its plain version; under autograd it raises."""
    from repro_torch.kernels import ops
    x = torch.from_numpy(_np((2, 5, 64), 140)).to(cuda)
    w = torch.from_numpy(_np((64, 48), 141)).to(cuda)
    bias = torch.from_numpy(_np((48,), 142)).to(cuda)
    before = flex_gemm.launches
    got = ops.linear(x, w, bias, epilogue)
    torch.cuda.synchronize()
    assert flex_gemm.launches == before + 1 and got.shape == (2, 5, 48)
    want = ops.linear(x, w, bias, epilogue, plain=True)
    assert flex_gemm.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * 8)
    with pytest.raises(RuntimeError, match="A.5b"):
        ops.linear(x, w.clone().requires_grad_(True), bias, epilogue)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,wrapper", [("softmax", softmax_rows),
                                        ("gelu", act_rows)])
def test_cuda_ops_softmax_and_gelu_launch_their_kernel_once(cuda, fn,
                                                            wrapper):
    from repro_torch.kernels import ops
    x = torch.from_numpy(_np((3, 7, 197), 143, scale=3.0)).to(cuda)
    before = wrapper.launches
    got = getattr(ops, fn)(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.shape == x.shape
    want = getattr(ops, fn)(x, plain=True)
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    with pytest.raises(RuntimeError, match="A.5b"):
        getattr(ops, fn)(x.clone().requires_grad_(True))


# The four-card mode of chip_smoke.py and the world it starts: a machine
# with fewer cards refuses the mode at once (a four-card machine is shown
# one card); on four cards each rank of a FileStore world takes its own.
ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.cuda
def test_cuda_cards_mode_raises_on_fewer_cards(cuda):
    env = dict(os.environ)
    if torch.cuda.device_count() >= 4:
        env["CUDA_VISIBLE_DEVICES"] = "0"
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--cards", "4"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "--cards 4 needs 4 CUDA devices" in proc.stderr


_RANK = """
import sys, torch, torch.distributed as dist
from repro_torch.launch.mesh import join_world
rank, store = int(sys.argv[1]), sys.argv[2]
dev = join_world(rank, 4, store)
x = torch.full((1,), float(rank), device="cuda")
dist.all_reduce(x)
seen = [None] * 4
dist.all_gather_object(seen, (torch.cuda.current_device(), x.device.index,
                              float(x)))
assert dev == torch.device("cuda", rank), dev
assert seen == [(r, r, 6.0) for r in range(4)], seen
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_each_rank_of_a_world_takes_its_own_card(cuda, tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a rank a card)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(tmp_path / "store")], env=env)
             for r in range(4)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0, 0, 0]


# The reference's long shapes (src/repro/configs/shapes.py) at the kernels:
# prefill_32k's 32,768 query rows, decode_32k's cache past 32,768 rows
# (qwen3-4b's 32 heads over 8 at a batch of 2, 17 splits), long_500k's
# SSD scan cut to 131,072 positions (1,024 chunks in series).
def _long_attn_close(got, want, tdt):
    """Relative L2 within 2e-2 (bf16) or 1e-4 (fp32): over thousands of
    keys an output is of order 1/sqrt(keys) of v, so a fixed atol at
    bf16's 3e-2 would pass an error of the output's own size."""
    rtol = 1e-4 if tdt == torch.float32 else 2e-2
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).norm() / want.float().norm())
    assert err <= rtol, f"relative L2 {err} over {rtol}"


@pytest.mark.cuda
def test_cuda_flash_attention_prefill_at_32k_rows(cuda):
    """bf16 on the tensor cores, causal, against the chunked plain version
    that the model's plain path takes at this length."""
    q, k, v = _qkv((1, 8, 2, 32768, 32768, 128), 80, cuda, torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.mha_attention_chunked(q, k, v, causal=True)
    _long_attn_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_decode_over_32769_rows(cuda, tdt):
    assert fa.decode_plan(32769, 16, _build.sm_count(cuda)).splits > 1
    q, k, v = _qkv((2, 32, 8, 1, 32769, 128), 83, cuda, tdt, cache=32800)
    got = flash_attention(q, k, v, causal=False, kv_len=32769)
    torch.cuda.synchronize()
    want = ref.mha_attention(q, k, v, causal=False, kv_len=32769)
    _long_attn_close(got, want, tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ssd_at_131072_positions_matches_the_chained_plain(cuda, tdt):
    """mamba2-2.7b's widths over 131,072 positions, drawn on the card,
    against ``ref.ssd_chained`` over segments of 16,384 (the same
    recurrence; one plain call would hold 80 heads of b and c in fp32),
    segment by segment with ``_ssd_close``'s tolerances."""
    B, S, H, P, G, N = 1, 131072, 80, 64, 1, 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    dt = torch.rand((B, S, H), generator=gen, device=cuda) * 0.095 + 0.005
    a = -torch.linspace(1.0, 16.0, H, device=cuda)[None, None] * dt
    x = torch.randn((B, S, H, P), generator=gen, device=cuda).to(tdt)
    b, c = ((torch.randn((B, S, G, N), generator=gen, device=cuda) * 0.3
             ).to(tdt) for _ in range(2))
    y, state = ssd(x, a, b, c, chunk=128)
    torch.cuda.synchronize()
    rtol = 1e-4 if tdt == torch.float32 else 2 ** -7
    for s, y_seg, st in ref.ssd_chained(x, a, b, c, segment=16384,
                                        chunk=128):
        torch.testing.assert_close(y[:, s:s + 16384].float(), y_seg.float(),
                                   rtol=rtol, atol=1e-4)
    torch.testing.assert_close(state, st, rtol=1e-4, atol=1e-4)


# prefill_32k and decode_32k of the other archs at the kernels, cut in
# batch and heads: the norms on a prefill's 65,536 rows (nemotron-4-15b's
# and whisper-medium's layernorm, internlm2-20b's and qwen2-vl-2b's
# rmsnorm), whisper's non-causal D-64 attention over 32,768 keys, the
# decode over 32,800 rows at qwen1.5-4b's 40 (batch, KV head) pairs and
# over whisper's 32,768 cross rows at 32.
@pytest.mark.cuda
@pytest.mark.parametrize("kind,N", [("layernorm", 6144), ("layernorm", 1024),
                                    ("rmsnorm", 6144), ("rmsnorm", 1536)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_norms_on_65536_rows(cuda, kind, N, tdt):
    """The plan's kernel on 65,536 rows, with gamma (and beta), within the
    plain version's tolerance (bf16: one ulp) and the same bits on a
    repeated call: every row of the grid written."""
    x = torch.from_numpy(_np((65536, N), 91, scale=2.0)).to(cuda, tdt)
    g = torch.from_numpy(_np((N,), 92)).to(cuda)
    b = torch.from_numpy(_np((N,), 93)).to(cuda)
    fn, plain, args = ((layernorm_rows, ref.layernorm_rows, (g, b))
                       if kind == "layernorm"
                       else (rmsnorm_rows, ref.rmsnorm_rows, (g,)))
    got, again = fn(x, *args), fn(x, *args)
    torch.cuda.synchronize()
    assert got.dtype == tdt and torch.equal(got, again)
    rtol, atol = _ln_tol(tdt)
    torch.testing.assert_close(got.float(), plain(x, *args).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_non_causal_d64_over_32k_keys(cuda, tdt):
    """whisper-medium's encoder and cross-attention prefill at 32,768 frames
    for one (batch, head): non-causal at D 64 against the chunked plain
    version the model's plain path takes there."""
    q, k, v = _qkv((1, 1, 1, 32768, 32768, 64), 94, cuda, tdt)
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = ref.mha_attention_chunked(q, k, v, causal=False)
    _long_attn_close(got, want, tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kv_len", [
    ((2, 20, 20, 1, 32800, 128), 32769), ((2, 20, 20, 1, 32800, 128), 32800),
    ((2, 16, 16, 1, 32768, 64), 32768)],
    ids=["qwen1.5-4b-32769", "qwen1.5-4b-32800", "whisper-cross-32768"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_decode_at_40_and_32_pairs(cuda, shape, kv_len,
                                                        tdt):
    """Split-KV decode over a 32k cache at qwen1.5-4b's 40 (batch, KV head)
    pairs (GQA 1) and whisper-medium's 32 cross pairs (D 64), its splits
    and combine against the plain version; rows past ``kv_len`` are NaN
    and never read."""
    B, Hq, Hkv, _, rows, D = shape
    assert fa.decode_plan(kv_len, B * Hkv, _build.sm_count(cuda)).splits > 1
    q, k, v = _qkv((B, Hq, Hkv, 1, kv_len, D), 95, cuda, tdt, cache=rows)
    got = flash_attention(q, k, v, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    want = ref.mha_attention(q, k, v, causal=False, kv_len=kv_len)
    _long_attn_close(got, want, tdt)


# prefill_32k and decode_32k of the MoE archs and mamba2-2.7b at the
# kernels: llama4-maverick's 40 and jamba-1.5-large's 64 query heads over 8
# (a batch of 1 in the prefill, 2 over a 32,800-row cache in decode), the
# rmsnorm kernel on a prefill's 65,536 rows of llama4's 5,120, jamba's
# 8,192 and its gated norm's 16,384 (fp32 takes the block kernel there),
# and ssd at jamba's 256 heads and mamba2-2.7b's 80 over 2 x 32,768
# positions.
MOE_HEADS = [(40, 8), (64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", MOE_HEADS, ids=["llama4", "jamba"])
def test_cuda_flash_attention_prefill_at_32k_of_the_moe_archs(cuda, Hq, Hkv):
    """bf16 on the tensor cores, causal, every query head of the arch over
    32,768 rows, against the chunked plain version."""
    q, k, v = _qkv((1, Hq, Hkv, 32768, 32768, 128), 96, cuda,
                   torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.mha_attention_chunked(q, k, v, causal=True)
    _long_attn_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [32769, 32800])
@pytest.mark.parametrize("Hq,Hkv", MOE_HEADS, ids=["llama4", "jamba"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_decode_of_the_moe_archs_over_32k_rows(
        cuda, Hq, Hkv, kv_len, tdt):
    """Split-KV decode at GQA 5 and 8 over a 32,800-row cache, a batch of
    2: the splits and their combine against the plain version."""
    assert fa.decode_plan(kv_len, 2 * Hkv, _build.sm_count(cuda)).splits > 1
    q, k, v = _qkv((2, Hq, Hkv, 1, kv_len, 128), 97, cuda, tdt, cache=32800)
    got = flash_attention(q, k, v, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    want = ref.mha_attention(q, k, v, causal=False, kv_len=kv_len)
    _long_attn_close(got, want, tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [5120, 8192, 16384])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_rmsnorm_on_65536_rows_of_the_moe_archs(cuda, N, tdt):
    """The plan's kernel (the one-pass kernel, or fp32's block kernel at
    16,384) on 65,536 rows with gamma, within the plain version's
    tolerance, the same bits on a repeated call."""
    x = torch.from_numpy(_np((65536, N), 98, scale=2.0)).to(cuda, tdt)
    g = torch.from_numpy(_np((N,), 99)).to(cuda)
    got, again = rmsnorm_rows(x, g), rmsnorm_rows(x, g)
    torch.cuda.synchronize()
    assert got.dtype == tdt and torch.equal(got, again)
    rtol, atol = _ln_tol(tdt)
    torch.testing.assert_close(got.float(), ref.rmsnorm_rows(x, g).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 80], ids=["jamba", "mamba2"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_ssd_at_prefill_32k_matches_the_chained_plain(cuda, H, tdt):
    """Two rows of 32,768 positions (256 chunks each) at H heads of 64,
    state 128, from an initial state, drawn on the card, against
    ``ref.ssd_chained`` over segments of 16,384, with ``_ssd_close``'s
    tolerances."""
    B, S, P, G, N = 2, 32768, 64, 1, 128
    gen = torch.Generator(device=cuda).manual_seed(1)
    dt = torch.rand((B, S, H), generator=gen, device=cuda) * 0.095 + 0.005
    a = -torch.linspace(1.0, 16.0, H, device=cuda)[None, None] * dt
    x = torch.randn((B, S, H, P), generator=gen, device=cuda).to(tdt)
    b, c = ((torch.randn((B, S, G, N), generator=gen, device=cuda) * 0.3
             ).to(tdt) for _ in range(2))
    s0 = torch.randn((B, H, P, N), generator=gen, device=cuda)
    y, state = ssd(x, a, b, c, chunk=128, initial_state=s0)
    torch.cuda.synchronize()
    rtol = 1e-4 if tdt == torch.float32 else 2 ** -7
    for s, y_seg, st in ref.ssd_chained(x, a, b, c, segment=16384,
                                        chunk=128, initial_state=s0):
        torch.testing.assert_close(y[:, s:s + 16384].float(), y_seg.float(),
                                   rtol=rtol, atol=1e-4)
    torch.testing.assert_close(state, st, rtol=1e-4, atol=1e-4)
