"""The port's SFU row kernels against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions, which are held
against the Pallas kernels in interpret mode, the jnp oracles and the
numpy ``NonLinear.apply`` on the same seeded numpy inputs, with the
tolerances of tests/test_kernels.py.  The CUDA kernels are held against
the plain versions on the card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import NonLinear
from repro.kernels import ref as jref
from repro.kernels.sfu import (gelu_rows_pallas, layernorm_rows_pallas,
                               softmax_rows_pallas)
from repro_torch.kernels import act_rows, layernorm_rows, ref, softmax_rows
from repro_torch.kernels.ref import ACTIVATIONS

SFU_SHAPES = [(64, 128), (100, 300), (8, 17), (256, 512), (5, 1000)]
AFFINE = [(False, False), (True, False), (False, True), (True, True)]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _f32(x):
    """numpy fp32 view of a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SFU_SHAPES)
def test_softmax_rows(shape):
    x = _np(shape, 9, scale=3.0)
    got = _f32(softmax_rows(torch.from_numpy(x)))
    for want in (softmax_rows_pallas(jnp.asarray(x), interpret=True),
                 jref.softmax_rows(jnp.asarray(x)),
                 NonLinear.SOFTMAX.apply(x)):
        np.testing.assert_allclose(got, _f32(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SFU_SHAPES)
@pytest.mark.parametrize("affine", AFFINE, ids=["plain", "gamma", "beta",
                                                "gamma_beta"])
def test_layernorm_rows(shape, affine):
    x = _np(shape, 10)
    g = _np((shape[1],), 11) if affine[0] else None
    bt = _np((shape[1],), 12) if affine[1] else None
    t = (lambda v: None if v is None else torch.from_numpy(v))
    j = (lambda v: None if v is None else jnp.asarray(v))
    got = _f32(layernorm_rows(torch.from_numpy(x), t(g), t(bt)))
    wants = [layernorm_rows_pallas(jnp.asarray(x), j(g), j(bt),
                                   interpret=True),
             jref.layernorm_rows(jnp.asarray(x), j(g), j(bt))]
    if g is None and bt is None:
        wants.append(NonLinear.LAYERNORM.apply(x))
    for want in wants:
        np.testing.assert_allclose(got, _f32(want), rtol=1e-4, atol=1e-5)


# bf16 layernorm rows: the SFU sweep, the narrowest one-pass row, and
# nemotron-4-15b's decode rows
LN_BF16_SHAPES = SFU_SHAPES + [(2, 1032), (4, 6144)]


@pytest.mark.parametrize("shape", LN_BF16_SHAPES)
@pytest.mark.parametrize("affine", AFFINE, ids=["plain", "gamma", "beta",
                                                "gamma_beta"])
def test_layernorm_bf16_rows(shape, affine):
    """bf16 rows with fp32 gamma and beta, as nemotron-4-15b serves them:
    the output stays bf16 and is within one bf16 ulp (2^-7 relative) of
    the Pallas kernel's and the oracle's on the same bf16 inputs; all
    compute in fp32 and round once, so only the fp32 summation order
    differs."""
    xb = torch.from_numpy(_np(shape, 14, scale=4.0)).to(torch.bfloat16)
    g = _np((shape[1],), 15) if affine[0] else None
    bt = _np((shape[1],), 16) if affine[1] else None
    t = (lambda v: None if v is None else torch.from_numpy(v))
    j = (lambda v: None if v is None else jnp.asarray(v))
    got = layernorm_rows(xb, t(g), t(bt))
    assert got.dtype == torch.bfloat16
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    for want in (layernorm_rows_pallas(jx, j(g), j(bt), interpret=True),
                 jref.layernorm_rows(jx, j(g), j(bt))):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", SFU_SHAPES)
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_act_rows(shape, act):
    x = _np(shape, 13, scale=2.0)
    got = _f32(act_rows(torch.from_numpy(x), act))
    wants = [NonLinear(act).apply(x)]
    if act == "gelu":
        wants += [gelu_rows_pallas(jnp.asarray(x), interpret=True),
                  jref.gelu_rows(jnp.asarray(x))]
    for want in wants:
        np.testing.assert_allclose(got, _f32(want), rtol=1e-5, atol=1e-6)
