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
forwards.  The bf16 attention backward runs on the tensor cores with P
and dS rounded to bf16 before their products; ``_emulate_attention_bwd``
repeats that arithmetic here and shows its margin under the card's
limit.  The backward's launch plans are pure functions, checked here.
"""

import math

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
# the card holds bf16 dq, dk, dv to a relative L2 of 2e-2 (BF16_GRAD_RTOL in
# chip_smoke.py, tests/test_torch_cuda.py); the emulated tensor-core
# arithmetic must reach a quarter of it against fp32 references on the same
# bf16 inputs, so that the card's limit has a margin of 4x over the
# roundings (P and dS before their products, the outputs at the store)
EMU_RTOL = 2e-2 / 4
# qwen3-4b's training attention cut to one batch row and 256 tokens (32/8
# heads of 128 cut to 8/2), and a ragged GQA-4 case with Sq != Skv whose
# lengths are no multiple of any tile
ATTN_BF16_SHAPES = ATTN_SHAPES + [(1, 8, 2, 256, 256, 128),
                                  (1, 8, 2, 100, 130, 128)]


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


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _emulate_attention_bwd(q, k, v, out, lse, dout, causal):
    """The bf16 tensor-core backward kernels' arithmetic (csrc/
    flash_attention.cu, section 5) in plain torch, on fp32 tensors that
    hold bf16 values: fp32 sums of exact bf16 products for S and dP,
    ``p = 2^(s scale log2 e - lse log2 e)`` over the visible keys (0
    elsewhere), dS from the fp32 P, then P rounded to bf16 for dV and dS
    rounded to bf16 for dK and dQ, dK and dQ scaled in fp32, each output
    rounded to bf16 once."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf, vf = (t.repeat_interleave(group, dim=1) for t in (k, v))
    scale, log2e = 1.0 / math.sqrt(D), 1.4426950408889634
    s = q @ kf.transpose(-1, -2)
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    seen = j <= i + (Skv - Sq) if causal else torch.ones(Sq, Skv, dtype=bool)
    p = torch.where(seen, torch.exp2(s * (scale * log2e)
                                     - lse[..., None] * log2e), 0.0)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (dout @ vf.transpose(-1, -2) - delta)
    p16, ds16 = _bf16(p), _bf16(ds)
    dq = scale * (ds16 @ kf)
    dk = (scale * (ds16.transpose(-1, -2) @ q)).view(
        B, Hkv, group, Skv, D).sum(2)
    dv = (p16.transpose(-1, -2) @ dout).view(B, Hkv, group, Skv, D).sum(2)
    return _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("shape", ATTN_BF16_SHAPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_attention_bwd_emulation_meets_the_card_limit(shape, causal):
    B, Hq, Hkv, Sq, Skv, D = shape
    q, k, v, do = (_bf16(torch.from_numpy(_np(s, i))) for i, s in enumerate(
        ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
         (B, Hq, Sq, D)), 10))
    # the forward kernel's bf16 output and fp32 log-sum-exp
    out, lse = attention_lse(q, k, v, causal=causal)
    got = _emulate_attention_bwd(q, k, v, _bf16(out), lse, do, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, causal=causal).backward(do)
    for g, leaf, name in zip(got, leaves, "qkv"):
        assert _rel_l2(g, leaf.grad) <= EMU_RTOL, (f"d{name} vs autograd",
                                                   _rel_l2(g, leaf.grad))
    if not causal or Sq <= Skv:     # every row sees a key: the oracle holds
        _, vjp = jax.vjp(lambda a, b, c: jref.mha_attention(
            a, b, c, causal=causal), *(jnp.asarray(t.numpy())
                                       for t in (q, k, v)))
        for g, w, name in zip(got, vjp(jnp.asarray(do.numpy())), "qkv"):
            w = torch.from_numpy(np.array(w))
            assert _rel_l2(g, w) <= EMU_RTOL, (f"d{name} vs jax",
                                               _rel_l2(g, w))


def test_bf16_attention_bwd_emulation_gives_empty_rows_no_gradient():
    # causal, Sq > Skv: rows 0-39 see no key (their lse is -1e30)
    q, k, v, do = (_bf16(torch.from_numpy(_np(s, i))) for i, s in enumerate(
        ((1, 4, 80, 64), (1, 2, 40, 64), (1, 2, 40, 64), (1, 4, 80, 64)), 40))
    out, lse = attention_lse(q, k, v, causal=True)
    assert (lse[0, :, :40] == ref.NEG_INF).all()
    dq, dk, dv = _emulate_attention_bwd(q, k, v, _bf16(out), lse, do, True)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[0, :, :40].any() and dq[0, :, 41:].abs().amin(-1).gt(0).all()


@pytest.mark.parametrize("R", [1, 7, 2048, 65536])
@pytest.mark.parametrize("N,esize,aligned", [(128, 2, True), (2560, 2, True),
                                             (2560, 4, True), (2561, 4, True),
                                             (6144, 2, False),
                                             (16384, 4, True), (6144, 4, True),
                                             (1024, 2, True), (512, 2, True),
                                             (256, 4, True), (256, 2, True)])
def test_norm_bwd_plan_takes_the_forward_shape_on_a_bounded_grid(
        R, N, esize, aligned):
    """Rows wider than 1,024 that the forward's one-pass kernel takes keep
    its threads up to BWD_VEC_THREADS (fp32 rows past 5,120 go to the
    block kernel); rows of 64 to 128 aligned 16-byte vectors take the
    vector kernel too; narrower rows a warp a row."""
    sms = 132
    threads, rows, blocks = sfu.norm_bwd_plan(R, N, esize, aligned, sms)
    assert threads == sfu.norm_bwd_threads(N, esize, aligned)
    forward = sfu.norm_plan(N, esize, aligned)
    assert threads == (forward if forward <= sfu.BWD_VEC_THREADS else 0) \
        or N <= sfu.WARP_ROW_MAX
    assert bool(threads) == (aligned and N * esize % 16 == 0 and
                             sfu.BWD_VEC_MIN <= N * esize // 16 <=
                             sfu.ROW_VPT * sfu.BWD_VEC_THREADS)
    assert blocks <= -(-R // rows)           # no block without a row
    per_sm = sfu.BWD_BLOCKS_PER_SM
    if threads:                              # vector kernel: row groups
        assert rows == max(1, min(sfu.BWD_VEC_THREADS // threads,
                                  sfu.BWD_VEC_SMEM_FLOATS // N))
        assert rows * threads <= sfu.BWD_VEC_THREADS
        assert rows * N <= sfu.BWD_VEC_SMEM_FLOATS or rows == 1
        assert 1 <= blocks <= per_sm["vector"] * sms
    elif N <= sfu.WARP_ROW_MAX:              # warp kernel: a warp a row
        assert 1 <= rows <= sfu.BWD_WARP_ROWS and rows * N <= \
            sfu.BWD_SMEM_FLOATS
        assert 1 <= blocks <= per_sm["warp"] * sms
    else:                                    # block kernel: a block a row
        assert rows == 1 and 1 <= blocks <= per_sm["block"] * sms
    assert sfu.norm_bwd_plan(R, N, esize, aligned, sms) == \
        (threads, rows, blocks)
    # fewer SMs, no more blocks
    assert sfu.norm_bwd_plan(R, N, esize, aligned, 66)[2] <= blocks


def test_norm_bwd_plan_at_qwen3_4b_training_rows():
    # 2048 x 2560 bf16 rows: the vector kernel, 160 threads a row, 4 rows
    # a block of 640 threads, one block an SM; the q-norm's 65,536 x 128
    # and the k-norm's 16,384 (16 vectors a row, fewer than a warp's 64):
    # the warp kernel, 32 rows a block, two blocks an SM, which the card
    # measured faster there than the vector kernel (65,536 rows: 0.0299
    # against 0.0381 ms for one warp a row, 20 rows a block; PERF.md)
    assert sfu.norm_bwd_plan(2048, 2560, 2, True, 132) == (160, 4, 132)
    assert sfu.norm_bwd_plan(65536, 128, 2, True, 132) == (0, 32, 264)
    assert sfu.norm_bwd_plan(16384, 128, 2, True, 132) == (0, 32, 264)
    assert sfu.norm_bwd_plan(8, 128, 2, True, 132) == (0, 32, 1)
    # dgamma's column sum over those partial rows: 16-byte vectors, 32
    # warps of at most 9 rows
    assert sfu.column_sum_plan(132, 2560) == (4, 32)
    assert sfu.column_sum_plan(264, 128) == (4, 32)


@pytest.mark.parametrize("blocks", [1, 7, 8, 9, 132, 256, 528, 4096])
@pytest.mark.parametrize("N", [17, 128, 1000, 2560, 2561])
def test_column_sum_plan_spreads_the_rows_over_warps(blocks, N):
    vec, warps = sfu.column_sum_plan(blocks, N)
    assert vec == (4 if N % 4 == 0 else 1) and N % vec == 0
    assert 1 <= warps <= sfu.SUM_WARPS
    # each warp adds at most SUM_ROWS rows unless the block is full
    assert warps == sfu.SUM_WARPS or -(-blocks // warps) <= sfu.SUM_ROWS
    assert warps <= blocks
