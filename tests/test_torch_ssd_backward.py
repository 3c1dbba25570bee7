"""The arithmetic of the layernorm and SSD backward kernels, on the CPU.

``csrc/sfu.cu``'s layernorm backward and ``csrc/ssd.cu``'s SSD backward
have plain versions in ``kernels/ref.py`` that compute their formulas
step by step: ``layernorm_bwd`` from the forward's saved mean and rstd
(``layernorm_stats``), ``ssd_bwd`` as the chunked algorithm's backward (a
reverse recurrence over the chunks for the state's gradient, the
intra-chunk terms through L = exp(acs[t] - acs[s]), da by an in-chunk
reverse cumsum).  Each is held here against ``jax.vjp`` of the
reference's jnp oracles and against autograd of the port's plain
forwards, on seeded numpy inputs, fp32, within 1e-4 · max|g| per
gradient (the limit the card holds the kernels to).  The wrappers take
these plain versions for CPU tensors; the card tests (test_torch_cuda.py)
hold the kernels against autograd of the plain forwards.  The launch
plans of both backwards are pure functions, checked here, and the bf16
SSD backward's tensor-core arithmetic (each fp32 operand of a bf16
product split into a high and a low part) is emulated in plain torch
against the card's limits.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import layernorm_bwd, layernorm_rows, ref, sfu
from repro_torch.kernels.ssd import ssd, ssd_bwd, ssd_bwd_plan, ssd_states

# the module, not the wrapper of the same name that the package exports
ssd_mod = importlib.import_module("repro_torch.kernels.ssd")

GRAD_TOL = 1e-4
# rows of 8 to 1,100: the reference's SFU rows, whisper-medium's width and
# one past the warp kernels' 1,024
LN_SHAPES = [(64, 128), (100, 300), (8, 17), (256, 512), (5, 1000),
             (16, 1024), (3, 1100)]
LN_FORMS = ["gamma_beta", "gamma", "beta", "plain"]
# (B, S, H, P, G, N, chunk): G 1 and G > 1, chunks 16 and 32, S a multiple
# of the chunk and longer (the chunked oracle), and tails (the recurrence)
SSD_SHAPES = [(2, 64, 4, 8, 2, 4, 16), (1, 64, 2, 8, 1, 4, 32),
              (2, 96, 4, 16, 1, 8, 32), (2, 50, 4, 8, 2, 4, 16),
              (1, 77, 8, 16, 4, 8, 32)]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-30), (what, err)


def _ln_inputs(shape, form, seed=1):
    R, N = shape
    x, dy = _np(shape, seed, 2.0), _np(shape, seed + 1)
    g = 1.0 + _np((N,), seed + 2, 0.2) if "gamma" in form else None
    b = _np((N,), seed + 3, 0.2) if "beta" in form else None
    return x, dy, g, b


@pytest.mark.parametrize("shape", LN_SHAPES)
@pytest.mark.parametrize("form", LN_FORMS)
def test_layernorm_bwd_formula_matches_jax_vjp_and_autograd(shape, form):
    x, dy, g, b = _ln_inputs(shape, form)
    present = [t for t in (x, g, b) if t is not None]

    def fn(xx, *gb):
        it = iter(gb)
        return jref.layernorm_rows(xx, next(it) if g is not None else None,
                                   next(it) if b is not None else None)
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in present))
    want = list(vjp(jnp.asarray(dy)))
    # the port's plain forward, differentiated by autograd
    leaves = [None if t is None else torch.tensor(t, requires_grad=True)
              for t in (x, g, b)]
    layernorm_rows(*leaves).backward(torch.from_numpy(dy))
    # the backward kernel's formula from the saved mean and rstd
    xt = torch.from_numpy(x)
    mean, rstd = ref.layernorm_stats(xt)
    got = layernorm_bwd(xt, *(None if t is None else torch.from_numpy(t)
                              for t in (g, b)), mean, rstd,
                        torch.from_numpy(dy))
    for name, kern, leaf in zip(("dx", "dgamma", "dbeta"), got, leaves):
        if leaf is None:
            assert kern is None, name
            continue
        w = want.pop(0)
        _close(kern, w, f"{name} vs jax")
        _close(leaf.grad, w, f"autograd {name} vs jax")


def test_layernorm_stats_are_the_forward_s():
    x = torch.from_numpy(_np((37, 1000), 5, 3.0))
    mean, rstd = ref.layernorm_stats(x)
    assert mean.dtype == rstd.dtype == torch.float32
    torch.testing.assert_close(
        (x - mean[:, None]) * rstd[:, None], ref.layernorm_rows(x),
        rtol=0, atol=1e-6)


def test_layernorm_bwd_bf16_rounds_dx_once():
    # bf16 rows: the formula in fp32 on the bf16 values, dx rounded to
    # bf16 once at the end; dgamma and dbeta stay fp32
    x, dy, g, b = _ln_inputs((64, 1024), "gamma_beta", 7)
    xb, dyb = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, dy))
    mean, rstd = ref.layernorm_stats(xb)
    dx, dg, db = layernorm_bwd(xb, torch.from_numpy(g), torch.from_numpy(b),
                               mean, rstd, dyb)
    assert dx.dtype == torch.bfloat16 and dg.dtype == db.dtype == \
        torch.float32
    d32 = ref.layernorm_bwd(xb.float(), torch.from_numpy(g),
                            torch.from_numpy(b), mean, rstd, dyb.float())
    assert torch.equal(dx, d32[0].to(torch.bfloat16))
    assert torch.equal(dg, d32[1]) and torch.equal(db, d32[2])
    # and it is the gradient of the bf16 rows, within bf16's rounding
    leaves = [t.float().requires_grad_() for t in (xb,)] + \
        [torch.tensor(t, requires_grad=True) for t in (g, b)]
    ref.layernorm_rows(*leaves).backward(dyb.float())
    rel = float((dx.float() - leaves[0].grad).norm() / leaves[0].grad.norm())
    assert rel <= 2 ** -8
    _close(dg, leaves[1].grad, "dgamma")
    _close(db, leaves[2].grad, "dbeta")


def _ssd_inputs(shape, seed):
    """x ~ N(0, 1), a = -|N(0, 0.1²)|, b and c ~ N(0, 0.3²), as the
    reference's ``_ssd_inputs``; dy ~ N(0, 1), the initial state and the
    final state's gradient ~ N(0, 1)."""
    B, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    a = -np.abs(rng.normal(size=(B, S, H))) * 0.1
    b = rng.normal(size=(B, S, G, N)) * 0.3
    c = rng.normal(size=(B, S, G, N)) * 0.3
    dy = rng.normal(size=(B, S, H, P))
    init = rng.normal(size=(B, H, P, N))
    dfin = rng.normal(size=(B, H, P, N))
    return [v.astype(np.float32) for v in (x, a, b, c, dy, init, dfin)]


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
@pytest.mark.parametrize("start", ["zero", "init"])
def test_ssd_bwd_formula_matches_jax_vjp_and_autograd(shape, start):
    """From zero (the gradient of y alone) and from an initial state (with
    a gradient into the final state too): ``ref.ssd_bwd`` against
    ``jax.vjp`` of the reference's oracle (``ssd_chunked`` where S is a
    multiple of the chunk and longer, else ``ssd_scan``, as its
    ``ops.ssd`` chooses) and against autograd of ``ref.ssd_plain``."""
    B, S, H, P, G, N, chunk = shape
    x, a, b, c, dy, init, dfin = _ssd_inputs(shape, 11)
    with_init = start == "init"
    chunked = S % chunk == 0 and S > chunk

    def oracle(*ops):
        st = ops[4] if with_init else None
        if chunked:
            return jref.ssd_chunked(*ops[:4], chunk=chunk, initial_state=st)
        return jref.ssd_scan(*ops[:4], initial_state=st)
    ops = [x, a, b, c] + ([init] if with_init else [])
    _, vjp = jax.vjp(oracle, *(jnp.asarray(t) for t in ops))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin if with_init else
                                             np.zeros_like(dfin))))
    leaves = [torch.tensor(t, requires_grad=True) for t in ops]
    y, fin = ref.ssd_plain(*leaves[:4], chunk=chunk,
                           initial_state=leaves[4] if with_init else None)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_init:
        loss = loss + (fin * torch.from_numpy(dfin)).sum()
    loss.backward()
    got = ref.ssd_bwd(*(torch.from_numpy(t) for t in (x, a, b, c, dy)),
                      chunk=chunk,
                      initial_state=torch.from_numpy(init) if with_init
                      else None,
                      dfinal=torch.from_numpy(dfin) if with_init else None)
    assert (got[4] is None) == (not with_init)
    for name, g, w, leaf in zip(("dx", "da", "db", "dc", "dinit"), got,
                                want, leaves):
        _close(g, w, f"{name} vs jax")
        _close(leaf.grad, w, f"autograd {name} vs jax")


def test_ssd_bwd_wrapper_on_the_cpu_is_the_plain_version():
    shape = (2, 50, 4, 8, 2, 4, 16)
    x, a, b, c, dy, init, dfin = (torch.from_numpy(t)
                                  for t in _ssd_inputs(shape, 13))
    got = ssd_bwd(x, a, b, c, dy, chunk=16, initial_state=init, dfinal=dfin)
    want = ref.ssd_bwd(x, a, b, c, dy, chunk=16, initial_state=init,
                       dfinal=dfin)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # ssd_states keeps no scratch on the CPU; the wrapper's forward is the
    # plain version and autograd differentiates it
    y, fin, states = ssd_states(x, a, b, c, chunk=16, initial_state=init)
    assert states is None
    assert all(torch.equal(u, v) for u, v in zip(
        (y, fin), ssd(x, a, b, c, chunk=16, initial_state=init)))
    before = (ssd.launches, ssd_bwd.launches)
    xl = x.clone().requires_grad_()
    ssd(xl, a, b, c, chunk=16)[0].backward(dy)
    assert (ssd.launches, ssd_bwd.launches) == before   # no kernel here
    _close(xl.grad, ref.ssd_bwd(x, a, b, c, dy, chunk=16)[0], "dx")


def test_ssd_bwd_checks_its_operands():
    shape = (1, 32, 2, 8, 1, 4, 16)
    x, a, b, c, dy, init, dfin = (torch.from_numpy(t)
                                  for t in _ssd_inputs(shape, 17))
    with pytest.raises(ValueError, match="dy"):
        ssd_bwd(x, a, b, c, dy[:, :16], chunk=16)
    with pytest.raises(ValueError, match="dfinal"):
        ssd_bwd(x, a, b, c, dy, chunk=16, dfinal=dfin.double())


@pytest.mark.parametrize("shape", [(4, 512, 80, 64, 1, 128, 128),
                                   (4, 512, 256, 64, 1, 128, 128),
                                   (2, 77, 8, 32, 4, 16, 32),
                                   (1, 100, 2, 8, 1, 4, 64),
                                   (2, 37, 80, 64, 1, 128, 37),
                                   (1, 5, 2, 8, 1, 4, 16)], ids=str)
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("sms", [132, 66])
def test_ssd_bwd_plan_fits_the_card(shape, bf16, sms):
    B, S, H, P, G, N, chunk = shape
    plan = ssd_bwd_plan(B, S, H, P, G, N, chunk, sms, bf16)
    fwd = ssd_mod.ssd_plan(B, S, H, P, N, chunk)
    # the forward's chunks and state grid; a block per (chunk, head block
    # of one group, batch): heads 1 for fp32, up to BWD_MAX_HEADS for bf16
    assert (plan.chunk, plan.chunks, plan.state_grid) == \
        (fwd.chunk, fwd.chunks, fwd.state_grid)
    rep = H // G
    assert 1 <= plan.heads <= min(rep, ssd_mod.BWD_MAX_HEADS)
    assert bf16 or plan.heads == 1
    hblocks = -(-rep // plan.heads)
    assert plan.grid == (fwd.chunks, G * hblocks, B)
    # scratch: the states' gradients, and db and dc a head block
    assert plan.scratch_bytes == fwd.scratch_bytes + 8 * B * S * G * \
        hblocks * N
    if bf16:
        # tiles of the chunk rounded up to 16 rows, in the fixed shared
        # memory of the tensor-core kernel (one block an SM)
        assert plan.rows == -(-plan.chunk // 16) * 16
        assert plan.smem_bytes == ssd_mod.BWD_MMA_SMEM
        assert ssd_mod.SMEM_MAX // 2 < plan.smem_bytes <= ssd_mod.SMEM_MAX
        # no other head count gives the busiest SM fewer head-chunks
        rounds = [-(-plan.chunks * G * -(-rep // k) * B // sms) * k
                  for k in range(1, min(rep, ssd_mod.BWD_MAX_HEADS) + 1)]
        assert rounds[plan.heads - 1] == min(rounds)
    else:
        # tiles of 16, 32, 64 or 128 rows cover the chunk; one block an SM
        assert plan.rows in (16, 32, 64, 128) and plan.rows >= plan.chunk
        assert plan.rows == 16 or plan.rows // 2 < plan.chunk
        assert plan.smem_bytes <= ssd_mod.SMEM_MAX
    # the group sum: a thread an element of db, and a second row for dc
    assert plan.group_grid[1] == 2
    assert plan.group_grid[0] * ssd_mod.GROUP_SUM_THREADS >= B * S * G * N


def test_ssd_bwd_plan_at_mamba2_training():
    # 4 x 512 tokens, 80 heads of 64, state 128, one group, chunk 128: 4
    # chunks.  bf16 on 132 SMs: 10 heads a block, 4 x 8 x 4 = 128 blocks
    # of 211,216 bytes (R and Z stored as hi and lo tiles among them),
    # one round (1, 2 and 5 heads tie at 10 head-chunks on the busiest SM;
    # more heads stage C and B fewer times); db and dc scratch of 8 head
    # blocks, 16.8 MB (84 MB a head).  fp32: a block a head, 1,280 blocks
    # of 208,928 bytes.  The state kernel's 4 column blocks a (head,
    # batch) either way.
    plan = ssd_bwd_plan(4, 512, 80, 64, 1, 128, 128, 132)
    assert plan.heads == 10 and plan.grid == (4, 8, 4)
    assert plan.state_grid == (4, 80, 4)
    assert plan.rows == 128 and plan.smem_bytes == 211216
    assert plan.group_grid == (1024, 2)
    assert plan.scratch_bytes == 4 * 4 * 4 * 80 * 64 * 128 \
        + 2 * 4 * 4 * 512 * 8 * 128
    f32 = ssd_bwd_plan(4, 512, 80, 64, 1, 128, 128, 132, bf16=False)
    assert f32.heads == 1 and f32.grid == (4, 80, 4)
    assert f32.rows == 128 and f32.smem_bytes == 208928
    assert f32.scratch_bytes == 4 * 4 * 4 * 80 * 64 * 128 \
        + 2 * 4 * 4 * 512 * 80 * 128
    # jamba's 256 heads: 16 a block, 256 blocks in two rounds
    assert ssd_bwd_plan(4, 512, 256, 64, 1, 128, 128, 132).grid == \
        (4, 16, 4)


@pytest.mark.parametrize("R", [1, 7, 2048, 6000])
@pytest.mark.parametrize("N,esize,aligned", [(1024, 2, True), (768, 4, True),
                                             (6144, 2, True), (6144, 4, True),
                                             (2561, 4, True),
                                             (6144, 2, False), (1025, 2, True),
                                             (1024, 2, False), (1024, 4, True),
                                             (1000, 2, True), (1000, 4, False),
                                             (768, 2, True), (768, 2, False)])
@pytest.mark.parametrize("parts", [0, 1, 2])
def test_layernorm_bwd_plan_keeps_its_partial_rows_in_shared_memory(
        R, N, esize, aligned, parts):
    """layernorm's backward keeps up to two partial rows a block (dgamma
    and dbeta): the grid of rmsnorm's backward, with the rows a block
    shrunk so that its shared partial rows fit."""
    sms = 132
    threads, rows, blocks = sfu.norm_bwd_plan(R, N, esize, aligned, sms,
                                              parts)
    assert threads == sfu.norm_bwd_threads(N, esize, aligned)
    assert 1 <= blocks <= -(-R // rows)
    shared = max(1, parts) * N
    if threads:
        assert rows == 1 or rows * shared <= sfu.BWD_VEC_SMEM_FLOATS
        assert rows * threads <= sfu.BWD_VEC_THREADS
    elif N <= sfu.WARP_ROW_MAX:
        assert 1 <= rows <= sfu.BWD_WARP_ROWS
        assert rows * shared <= sfu.BWD_SMEM_FLOATS
    else:
        assert rows == 1
    # one partial row (rmsnorm's) gives rmsnorm's plan
    if parts <= 1:
        assert (threads, rows, blocks) == sfu.norm_bwd_plan(R, N, esize,
                                                            aligned, sms)


@pytest.mark.parametrize("N", [768, 1000, 1024])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_layernorm_bwd_rows_up_to_1024_take_16_byte_vectors(N, esize,
                                                            aligned):
    """Rows of at most 1,024 of a whole number of aligned 16-byte vectors
    take the vector kernel (two vectors a thread, whole warps: 64 threads
    at 768 to 1,024 bf16, 96 or 128 at fp32), ten to six rows a block of at
    most BWD_VEC_THREADS; an offset view keeps the warp kernel's scalar
    loads."""
    threads, rows, blocks = sfu.norm_bwd_plan(2048, N, esize, aligned, 132, 2)
    if not aligned:
        assert threads == 0 and rows == min(sfu.BWD_WARP_ROWS,
                                            sfu.BWD_SMEM_FLOATS // (2 * N))
        assert blocks == min(-(-2048 // rows), 264)
        return
    vectors = N * esize // 16
    assert threads == {(768, 2): 64, (1000, 2): 64, (1024, 2): 64,
                       (768, 4): 96, (1000, 4): 128, (1024, 4): 128}[N, esize]
    assert threads % 32 == 0 and threads * sfu.ROW_VPT >= vectors > \
        (threads - 32) * sfu.ROW_VPT
    assert rows == sfu.BWD_VEC_THREADS // threads and blocks == 132


def test_layernorm_bwd_plan_at_whisper_and_nemotron_training_rows():
    # whisper-medium: 4 x 512 rows of 1024 bf16, gamma and beta: the vector
    # kernel, 64 threads a row (128 vectors, two a thread), 10 rows a block
    # of 640 threads (each row group's two shared rows of 1,024 floats: 80
    # KB), one block an SM; nemotron-4-15b's 6144: 384 threads a row, one
    # row a block (640 threads hold one), one block an SM
    assert sfu.norm_bwd_plan(2048, 1024, 2, True, 132, 2) == (64, 10, 132)
    assert sfu.norm_bwd_plan(2048, 6144, 2, True, 132, 2) == (384, 1, 132)
    assert sfu.column_sum_plan(132, 1024) == (4, 32)
    assert sfu.column_sum_plan(132, 6144) == (4, 32)


# ---------------------------------------------------------------------------
# The arithmetic of csrc/ssd.cu's bf16 backward, emulated in plain torch on
# the CPU: the reverse state recurrence and the chunk kernel's products,
# with every fp32 operand that enters a bf16 tensor-core product either
# split into a bf16 high and low part, as the kernels do, or rounded once.
# Products of bf16 operands are exact in fp32, so each tensor-core product
# is an fp32 einsum of the bf16 values.

# the fp32 operands: C o e (the state kernel's), R = (C B^T) o L, Z = (dY
# X^T) o L, the state's gradient G, the entering state S_prev
BWD_OPERANDS = ("ce", "r", "z", "g", "s")
# mamba2-2.7b's head and state widths, 8 heads, 3 chunks of 128
BWD_SPLIT_SHAPE = (1, 384, 8, 64, 1, 128)
CARD_RTOL = 2e-2     # the card's limit for bf16 gradients (relative L2)


def _split(v, split):
    """The fp32 ``v`` as a bf16 product takes it: hi + lo with lo =
    bf16(v - hi), or one rounding (lo = 0)."""
    hi = v.bfloat16().float()
    return hi, ((v - hi).bfloat16().float() if split
                else torch.zeros_like(v))


def _emulate_ssd_bwd_kernel(x, a, b, c, dy, *, chunk, initial_state=None,
                            dfinal=None, rounded_once=()):
    """csrc/ssd.cu's bf16 backward: (dx, da, db, dc, d initial state) as
    the kernels compute them from bf16 x, b, c, dy, fp32 a and the
    forward's fp32 entering states; the operands named in
    ``rounded_once`` (of ``BWD_OPERANDS``) rounded to bf16 once instead
    of split.  Row scales (w, e) multiply the fp32 products; Q, W and
    Yoff come from fp32 products; db and dc sum the heads in fp32 and
    round once."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    xf, yf = x.float(), dy.float()
    bf, cf = (v.float().repeat_interleave(rep, dim=2) for v in (b, c))
    L = min(chunk, S)
    starts = range(0, S, L)
    acs = [torch.cumsum(a[:, c0:c0 + L], dim=1) for c0 in starts]
    # the forward's entering states, fp32
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B, H, P, N)))
    prev = []
    for c0, ac in zip(starts, acs):
        sl = slice(c0, c0 + L)
        w = torch.exp(ac[:, -1:] - ac)
        prev.append(state)
        state = torch.exp(ac[:, -1])[..., None, None] * state + torch.einsum(
            "bshp,bshn->bhpn", xf[:, sl] * w[..., None], bf[:, sl])
    # a. G_prev = exp(acs_last) G + dY^T (C o e), C o e as hi + lo
    g = dfinal.float() if dfinal is not None else torch.zeros((B, H, P, N))
    grads = [None] * len(acs)
    for i in reversed(range(len(acs))):
        sl = slice(starts[i], starts[i] + L)
        grads[i] = g
        hi, lo = _split(cf[:, sl] * torch.exp(acs[i])[..., None],
                        "ce" not in rounded_once)
        g = torch.exp(acs[i][:, -1])[..., None, None] * g + sum(
            torch.einsum("bthp,bthn->bhpn", yf[:, sl], part)
            for part in (hi, lo))
    # b. the chunk kernel
    outs = [[], [], [], []]
    for c0, ac, sp, gs in zip(starts, acs, prev, grads):
        sl = slice(c0, c0 + L)
        xs, ys, bs, cs = xf[:, sl], yf[:, sl], bf[:, sl], cf[:, sl]
        n = xs.shape[1]
        ah = ac.transpose(1, 2)                               # (B, H, n)
        causal = torch.ones(n, n, dtype=torch.bool).tril()
        seg = torch.where(causal, ah[..., :, None] - ah[..., None, :], 0.0)
        lm = torch.where(causal, torch.exp(seg), 0.0)         # (B, H, t, s)
        w = torch.exp(ac[:, -1:] - ac)[..., None]             # (B, n, H, 1)
        e = torch.exp(ac)[..., None]
        cb = torch.einsum("bthn,bshn->bhts", cs, bs)
        yx = torch.einsum("bthp,bshp->bhts", ys, xs)
        q = cb * lm * yx
        r2 = _split(cb * lm, "r" not in rounded_once)
        z2 = _split(yx * lm, "z" not in rounded_once)
        g2 = _split(gs, "g" not in rounded_once)
        s2 = _split(sp, "s" not in rounded_once)
        dx_st = w * sum(torch.einsum("bshn,bhpn->bshp", bs, v) for v in g2)
        dx = dx_st + sum(torch.einsum("bhts,bthp->bshp", v, ys) for v in r2)
        dc_st = e * sum(torch.einsum("bthp,bhpn->bthn", ys, v) for v in s2)
        dc = dc_st + sum(torch.einsum("bhts,bshn->bthn", v, bs) for v in z2)
        db = w * sum(torch.einsum("bshp,bhpn->bshn", xs, v) for v in g2) \
            + sum(torch.einsum("bhts,bthn->bshn", v, cs) for v in z2)
        W = (xs * dx_st).sum(-1)
        dacs = (q.sum(-1) - q.sum(-2)).transpose(1, 2) \
            + (cs * dc_st).sum(-1) - W
        total = torch.exp(ac[:, -1]) * (gs * sp).sum((-1, -2)) + W.sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dacs, [1]), 1), [1]) \
            + total[:, None]
        for o, v in zip(outs, (dx, da, db, dc)):
            o.append(v)
    dx, da, db, dc = (torch.cat(o, dim=1) for o in outs)
    db, dc = (v.reshape(B, S, G, rep, N).sum(3) for v in (db, dc))
    return (dx.to(x.dtype), da, db.to(b.dtype), dc.to(b.dtype),
            g if initial_state is not None else None)


def _worst_rel_l2(got, want):
    return max(float((u.float() - v.float()).norm() / v.float().norm())
               for u, v in zip(got, want) if v is not None)


def _bwd_split_case(with_init, seed=70):
    """mamba2-2.7b-like bf16 operands (``test_torch_ssd._mamba_inputs``'
    decay range: A_log 1..16 over the heads, dt in [0.005, 0.1]), dy ~
    N(0, 1), and, with ``with_init``, an initial state and the final
    state's gradient ~ N(0, 1); and ``ref.ssd_bwd`` on them (fp32 sums,
    dx, db and dc rounded to bf16 once)."""
    B, S, H, P, G, N = BWD_SPLIT_SHAPE
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.005, 0.1, size=(B, S, H))
    a = torch.from_numpy((-np.linspace(1.0, 16.0, H)[None, None] * dt)
                         .astype(np.float32))
    x, dy = (torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(
        np.float32)).bfloat16() for _ in range(2))
    b, c = (torch.from_numpy((rng.normal(size=(B, S, G, N)) * 0.3).astype(
        np.float32)).bfloat16() for _ in range(2))
    init, dfin = (torch.from_numpy(rng.normal(size=(B, H, P, N)).astype(
        np.float32)) if with_init else None for _ in range(2))
    ops = dict(chunk=128, initial_state=init, dfinal=dfin)
    return (x, a, b, c, dy), ops, ref.ssd_bwd(x, a, b, c, dy, **ops)


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_ssd_bwd_kernel_split_arithmetic_sits_10x_inside_the_card_limit(
        with_init):
    """The kernels' bf16 arithmetic (every fp32 operand split), emulated at
    mamba2-2.7b's head and state widths over 3 chunks: every gradient
    (bf16 dx, db, dc; fp32 da and the initial state's) within relative L2
    2e-3 of ``ref.ssd_bwd``, ten times inside the card's 2e-2."""
    ops, kw, want = _bwd_split_case(with_init)
    got = _emulate_ssd_bwd_kernel(*ops, **kw)
    assert [None if t is None else t.dtype for t in got] == \
        [None if t is None else t.dtype for t in want]
    assert _worst_rel_l2(got, want) <= CARD_RTOL / 10


@pytest.mark.parametrize("once", BWD_OPERANDS)
def test_ssd_bwd_kernel_what_each_split_buys(once):
    """Each fp32 operand rounded to bf16 once, the others split, from an
    initial state: within the card's limit by relative L2 either way, but
    R or Z rounded once puts dx or db and dc past 2e-3 (2.5e-3-2.7e-3), out
    of the 10x margin, and every rounding costs at least 3x the split's
    error.  C o e, G and S_prev rounded once stay inside 2e-3 by relative
    L2 (0.5e-3-1.7e-3), but move the fp32 da (and, for C o e, the initial
    state's gradient) past the card tests' 1e-4 x max|ref| element by
    element (3e-4-2e-3; split: 3e-6): the kernels keep every split."""
    ops, kw, want = _bwd_split_case(True)
    split = _emulate_ssd_bwd_kernel(*ops, **kw)
    got = _emulate_ssd_bwd_kernel(*ops, **kw, rounded_once=(once,))
    rounded = _worst_rel_l2(got, want)
    assert rounded >= 3 * _worst_rel_l2(split, want)
    assert rounded <= CARD_RTOL
    assert (rounded > CARD_RTOL / 10) == (once in ("r", "z"))

    def fp32_worst(out):   # da and the initial state's gradient
        return max(float((u - v).abs().max() / v.abs().max())
                   for u, v in zip(out[1::3], want[1::3]))
    assert fp32_worst(split) <= 1e-5
    assert (fp32_worst(got) > GRAD_TOL) == (once in ("ce", "g", "s"))


def test_plain_chunked_ssd_gradient_stays_finite_past_exp_overflow():
    """With mamba2's strongest decay (A 16, dt 0.1: 1.6 a step) a chunk of
    128 spans exp(acs[t] - acs[s]) up to e^203 above the diagonal, where
    float32 overflows.  The plain chunked SSD takes the exponential of the
    pairs s <= t only, so its autograd stays finite (a where over an inf
    would give 0 x inf = NaN in da, as ``jax.grad`` of the reference's
    ``ssd_chunked`` does there) and equals ``ref.ssd_bwd`` and autograd of
    the recurrence."""
    B, S, H, P, G, N = 1, 256, 2, 4, 1, 4
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    a = torch.from_numpy((-np.linspace(1.0, 16.0, H)[None, None] * 0.1
                          * np.ones((B, S, H))).astype(np.float32))
    b, c = (torch.from_numpy((rng.normal(size=(B, S, G, N)) * 0.3).astype(
        np.float32)) for _ in range(2))
    dy = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    grads = []
    for fn in (lambda *t: ref.ssd_chunked(*t, chunk=128),
               lambda *t: ref.ssd_scan(*t)):
        leaves = [t.clone().requires_grad_() for t in (x, a, b, c)]
        fn(*leaves)[0].backward(dy)
        grads.append([t.grad for t in leaves])
    want = ref.ssd_bwd(x, a, b, c, dy, chunk=128)
    for name, g, r, w in zip(("dx", "da", "db", "dc"), grads[0], grads[1],
                             want):
        assert torch.isfinite(g).all(), name
        _close(g, r, f"{name} vs the recurrence")
        _close(g, w, f"{name} vs ssd_bwd")
