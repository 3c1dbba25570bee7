"""The arithmetic of the port's backward kernels, on the CPU.

rmsnorm's and flash attention's backward kernels (``csrc/sfu.cu``,
``csrc/flash_attention.cu``) have plain versions in ``kernels/ref.py``
that compute their formulas step by step: ``rmsnorm_bwd`` from the
forward's saved rstd, ``mha_attention_bwd`` (FlashAttention-2) from the
forward's output and log-sum-exp.  Each is held here against
``jax.vjp`` of the reference's jnp oracle and against autograd of the
port's plain forward, on seeded numpy inputs, fp32, within
1e-4 · max|g| per gradient (the limit the card holds the kernels to).  The
wrappers take these plain versions for CPU tensors; the card tests
(test_torch_cuda.py) hold the kernels against autograd of the plain
forwards.  The backward's launch plan is a pure function, checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, flash_attention_bwd, ref
from repro_torch.kernels import rmsnorm_bwd, rmsnorm_rows
from repro_torch.kernels import sfu
from repro_torch.kernels.flash_attention import attention_lse

SFU_SHAPES = [(64, 128), (100, 300), (8, 17), (256, 512), (5, 1000)]
ATTN_SHAPES = [(1, 4, 2, 64, 64, 32), (2, 8, 2, 32, 128, 64),
               (1, 2, 1, 1, 96, 32), (1, 4, 4, 50, 50, 16),
               (1, 2, 2, 1, 500, 64), (2, 6, 3, 40, 100, 32)]
GRAD_TOL = 1e-4


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("shape", SFU_SHAPES)
@pytest.mark.parametrize("with_gamma", [False, True], ids=["plain", "gamma"])
def test_rmsnorm_bwd_formula_matches_jax_vjp_and_autograd(shape, with_gamma):
    R, N = shape
    x, dy = _np(shape, 1, 2.0), _np(shape, 2)
    g = 1.0 + _np((N,), 3, 0.2) if with_gamma else None
    # the reference's oracle, differentiated by JAX
    fn = (lambda a, b: jref.rmsnorm_rows(a, b)) if with_gamma \
        else (lambda a: jref.rmsnorm_rows(a))
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (x, g) if t is not None))
    want = vjp(jnp.asarray(dy))
    # the port's plain forward, differentiated by autograd
    xt = torch.tensor(x, requires_grad=True)
    gt = torch.tensor(g, requires_grad=True) if with_gamma else None
    rmsnorm_rows(xt, gt).backward(torch.from_numpy(dy))
    # the backward kernel's formula from the saved rstd
    dx, dg = rmsnorm_bwd(torch.from_numpy(x),
                         None if g is None else torch.from_numpy(g),
                         ref.rmsnorm_rstd(torch.from_numpy(x)),
                         torch.from_numpy(dy))
    _close(dx, want[0], "dx vs jax")
    _close(xt.grad, want[0], "autograd dx vs jax")
    if with_gamma:
        _close(dg, want[1], "dgamma vs jax")
        _close(gt.grad, want[1], "autograd dgamma vs jax")
    else:
        assert dg is None


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_bwd_formula_matches_jax_vjp_and_autograd(shape, causal):
    B, Hq, Hkv, Sq, Skv, D = shape
    q, k, v = (_np(s, i) for i, s in enumerate(
        ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)), 10))
    do = _np((B, Hq, Sq, D), 13)
    # the Pallas kernel's semantics where the oracle differs (rows with no
    # visible key): the port's plain forward, by autograd, is the yardstick
    # there; elsewhere the reference's oracle, by jax.vjp
    qt, kt, vt = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    flash_attention(qt, kt, vt, causal=causal).backward(torch.from_numpy(do))
    out, lse = attention_lse(*(torch.from_numpy(t) for t in (q, k, v)),
                             causal=causal)
    grads = flash_attention_bwd(*(torch.from_numpy(t) for t in (q, k, v)),
                                out, lse, torch.from_numpy(do), causal=causal)
    for got, want, name in zip(grads, (qt.grad, kt.grad, vt.grad), "qkv"):
        _close(got, want, f"d{name} vs autograd")
    if not causal or Sq <= Skv:     # every row sees a key: the oracle holds
        _, vjp = jax.vjp(lambda a, b, c: jref.mha_attention(
            a, b, c, causal=causal), *(jnp.asarray(t) for t in (q, k, v)))
        for got, want, name in zip(grads, vjp(jnp.asarray(do)), "qkv"):
            _close(got, want, f"d{name} vs jax")


def test_attention_lse_is_the_log_sum_exp_of_the_visible_scores():
    q, k, v = _np((1, 2, 8, 16), 20), _np((1, 1, 5, 16), 21), \
        _np((1, 1, 5, 16), 22)
    out, lse = attention_lse(*(torch.from_numpy(t) for t in (q, k, v)),
                             causal=True)
    s = np.einsum("bhqd,bkd->bhqk", q, k[:, 0]) / 4.0
    for i in range(8):          # row i sees keys j <= i - 3
        seen = s[0, :, i, :max(0, i - 2)]
        want = np.log(np.exp(seen).sum(-1)) if seen.size else ref.NEG_INF
        np.testing.assert_allclose(lse[0, :, i].numpy(), want, rtol=1e-6)
    assert torch.equal(out, ref.mha_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=True))


def test_rows_without_a_key_get_no_gradient():
    q, k, v, do = _np((1, 1, 6, 16), 30), _np((1, 1, 3, 16), 31), \
        _np((1, 1, 3, 16), 32), _np((1, 1, 6, 16), 33)
    out, lse = attention_lse(*(torch.from_numpy(t) for t in (q, k, v)))
    dq, _, _ = flash_attention_bwd(*(torch.from_numpy(t) for t in (q, k, v)),
                                   out, lse, torch.from_numpy(do))
    # rows 0-2 see no key; row 3 sees one (its softmax is constant: no
    # gradient either); rows 4 and 5 see two and three
    assert torch.isfinite(dq).all()
    assert not dq[0, 0, :4].any() and dq[0, 0, 4:].abs().min() > 0


@pytest.mark.parametrize("R", [1, 7, 2048, 65536])
@pytest.mark.parametrize("N,esize,aligned", [(128, 2, True), (2560, 2, True),
                                             (2560, 4, True), (2561, 4, True),
                                             (6144, 2, False),
                                             (16384, 4, True)])
def test_norm_bwd_plan_takes_the_forward_shape_on_a_bounded_grid(
        R, N, esize, aligned):
    sms = 132
    threads, blocks = sfu.norm_bwd_plan(R, N, esize, aligned, sms)
    assert threads == sfu.norm_plan(N, esize, aligned)
    assert 1 <= blocks <= sfu.BWD_BLOCKS_PER_SM * sms
    per_block = sfu.WARP_ROWS if threads == 0 and N <= sfu.WARP_ROW_MAX else 1
    assert blocks <= -(-R // per_block)      # no block without a row
    assert sfu.norm_bwd_plan(R, N, esize, aligned, sms) == (threads, blocks)


def test_norm_bwd_plan_at_qwen3_4b_training_rows():
    # 2048 x 2560 bf16 rows: the vector kernel, 160 threads; the q-norm's
    # 65,536 x 128: the warp kernel, 8 rows a block over 528 blocks
    assert sfu.norm_bwd_plan(2048, 2560, 2, True, 132) == (160, 528)
    assert sfu.norm_bwd_plan(65536, 128, 2, True, 132) == (0, 528)
    assert sfu.norm_bwd_plan(8, 128, 2, True, 132) == (0, 1)
