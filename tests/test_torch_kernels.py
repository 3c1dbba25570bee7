"""The port's flex_gemm against the JAX package's, and the rules every
kernel wrapper keeps.

On the CPU the wrapper runs its plain PyTorch version, which is held
against the Pallas kernel in interpret mode and against the jnp oracle on
the same seeded numpy inputs, with the tolerances of tests/test_kernels.py.
The CUDA kernels are held against the plain versions on the card in
test_torch_cuda.py; the SFU row kernels' parity is in test_torch_sfu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import given, settings, strategies as st

from repro.core.isa import Epilogue
from repro.core.runtime import _apply_epilogue
from repro.kernels import ref as jref
from repro.kernels.flex_gemm import flex_gemm_pallas
from repro_torch.core.runtime import EPILOGUE_NAME
from repro_torch.kernels import act_rows, flex_gemm, layernorm_rows, ref, softmax_rows
from repro_torch.kernels.ref import EPILOGUES

GEMM_SHAPES = [(128, 128, 128), (100, 200, 300), (7, 33, 129),
               (256, 512, 384), (1, 17, 5), (130, 257, 131),
               (512, 64, 1024)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _f32(x):
    """numpy fp32 view of a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(tdtype):
    return (2e-2, 2e-2) if tdtype == torch.bfloat16 else (2e-5, 2e-5)


# ------------------------------------------------------------------ gemm

@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_gemm_matches_pallas_and_oracle(shape, dtypes):
    jdt, tdt = dtypes
    M, K, N = shape
    a, b = _np((M, K), 1), _np((K, N), 2)
    got = flex_gemm(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    rtol, atol = _tol(tdt)
    for want in (flex_gemm_pallas(ja, jb, block_m=128, block_k=128,
                                  block_n=128, interpret=True),
                 jref.gemm(ja, jb)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol * K ** 0.5)


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_gemm_epilogues(epilogue):
    a, b, bias = _np((96, 160), 3), _np((160, 224), 4), _np((224,), 5)
    got = flex_gemm(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(bias), epilogue=epilogue)
    ja, jb, jbias = jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias)
    for want in (flex_gemm_pallas(ja, jb, jbias, block_m=64, block_k=64,
                                  block_n=128, epilogue=epilogue,
                                  interpret=True),
                 jref.gemm(ja, jb, jbias, epilogue)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=2e-4)


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 150), st.integers(1, 150), st.integers(1, 150))
def test_gemm_dynamic_bounds_property(M, K, N):
    """One block shape, any operand shape: the plain version agrees with
    the Pallas kernel's masked remainders."""
    a, b = _np((M, K), M), _np((K, N), N)
    got = flex_gemm(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for want in (flex_gemm_pallas(ja, jb, block_m=64, block_k=64,
                                  block_n=128, interpret=True),
                 jref.gemm(ja, jb)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=2e-4)


@pytest.mark.parametrize("epi", list(Epilogue), ids=lambda e: e.name)
def test_gemm_accumulator_then_epilogue_matches_reference_runtime(epi):
    """``c`` is added before the epilogue, as the reference runtime does
    for an accumulating MMU_GEMM (runtime.py:98-100); Epilogue.BIAS is a
    no-op in both."""
    a, b, c = _np((40, 72), 6), _np((72, 56), 7), _np((40, 56), 8)
    got = flex_gemm(torch.from_numpy(a), torch.from_numpy(b),
                    epilogue=EPILOGUE_NAME[epi], c=torch.from_numpy(c))
    want = _apply_epilogue(c + a @ b, epi)
    np.testing.assert_allclose(_f32(got), want, rtol=2e-5, atol=2e-4)


# -------------------------------------------------------- wrapper rules

def _counts():
    return (flex_gemm.launches, softmax_rows.launches,
            layernorm_rows.launches, act_rows.launches)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = _counts()
    a, b = torch.from_numpy(_np((8, 16), 14)), torch.from_numpy(_np((16, 4), 15))
    torch.testing.assert_close(flex_gemm(a, b), ref.gemm(a, b), rtol=0, atol=0)
    x = torch.from_numpy(_np((4, 9), 16))
    torch.testing.assert_close(softmax_rows(x), ref.softmax_rows(x), rtol=0,
                               atol=0)
    torch.testing.assert_close(layernorm_rows(x), ref.layernorm_rows(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(act_rows(x, "silu"), ref.silu_rows(x), rtol=0,
                               atol=0)
    assert _counts() == before


def test_other_devices_raise_instead_of_falling_back():
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 4), device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        flex_gemm(a, b)
    for fn in (softmax_rows, layernorm_rows,
               lambda x: act_rows(x, "gelu")):
        with pytest.raises(ValueError, match="runs on cuda"):
            fn(a)


@pytest.mark.parametrize("case", [
    "k_mismatch", "dtype_mix", "fp16", "noncontiguous", "bias_missing",
    "bad_c", "bad_epilogue"])
def test_flex_gemm_rejects_bad_operands(case):
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    kwargs = {}
    if case == "k_mismatch":
        b = torch.ones(15, 4)
    elif case == "dtype_mix":
        b = b.to(torch.bfloat16)
    elif case == "fp16":
        a, b = a.half(), b.half()
    elif case == "noncontiguous":
        b = torch.ones(4, 16).t()
    elif case == "bias_missing":
        kwargs["epilogue"] = "bias_gelu"
    elif case == "bad_c":
        kwargs["c"] = torch.ones(4, 8)
    else:
        kwargs["epilogue"] = "tanh"
    with pytest.raises((ValueError, TypeError)):
        flex_gemm(a, b, **kwargs)


def test_sfu_rejects_bad_operands():
    x = torch.ones(4, 8)
    with pytest.raises(TypeError):
        softmax_rows(x.double())
    with pytest.raises(ValueError):
        softmax_rows(torch.ones(2, 4, 8))
    with pytest.raises(ValueError):
        layernorm_rows(torch.ones(8, 4).t())
    with pytest.raises(ValueError):
        layernorm_rows(x, torch.ones(7))
    with pytest.raises(ValueError):
        act_rows(x, "tanh")
