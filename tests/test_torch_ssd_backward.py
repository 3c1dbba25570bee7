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
plans of both backwards are pure functions, checked here.
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
def test_ssd_bwd_plan_fits_the_card(shape):
    B, S, H, P, G, N, chunk = shape
    plan = ssd_bwd_plan(B, S, H, P, G, N, chunk)
    fwd = ssd_mod.ssd_plan(B, S, H, P, N, chunk)
    # the forward's chunks, grids and scratch
    assert (plan.chunk, plan.chunks, plan.grid, plan.state_grid) == \
        (fwd.chunk, fwd.chunks, fwd.grid, fwd.state_grid)
    assert plan.scratch_bytes == fwd.scratch_bytes + 8 * B * S * H * N
    # tiles of 16, 32, 64 or 128 rows cover the chunk; one block an SM
    assert plan.rows in (16, 32, 64, 128) and plan.rows >= plan.chunk
    assert plan.rows == 16 or plan.rows // 2 < plan.chunk
    assert plan.smem_bytes <= ssd_mod.SMEM_MAX
    # the group sum: a thread an element of db, and a second row for dc
    assert plan.group_grid[1] == 2
    assert plan.group_grid[0] * ssd_mod.GROUP_SUM_THREADS >= B * S * G * N


def test_ssd_bwd_plan_at_mamba2_training():
    # 4 x 512 tokens, 80 heads of 64, state 128, one group, chunk 128: 4
    # chunks; 1,280 chunk blocks of 208,928 bytes; the state kernel's 4
    # column blocks a (head, batch); 84 MB of each head's db and dc
    plan = ssd_bwd_plan(4, 512, 80, 64, 1, 128, 128)
    assert plan.grid == (4, 80, 4) and plan.state_grid == (4, 80, 4)
    assert plan.rows == 128 and plan.smem_bytes == 208928
    assert plan.group_grid == (1024, 2)
    assert plan.scratch_bytes == 4 * 4 * 4 * 80 * 64 * 128 \
        + 2 * 4 * 4 * 512 * 80 * 128


@pytest.mark.parametrize("R", [1, 7, 2048, 6000])
@pytest.mark.parametrize("N,esize,aligned", [(1024, 2, True), (768, 4, True),
                                             (6144, 2, True), (6144, 4, True),
                                             (2561, 4, True),
                                             (6144, 2, False), (1025, 2, True)])
@pytest.mark.parametrize("parts", [0, 1, 2])
def test_layernorm_bwd_plan_keeps_its_partial_rows_in_shared_memory(
        R, N, esize, aligned, parts):
    """layernorm's backward keeps up to two partial rows a block (dgamma
    and dbeta): the grid of rmsnorm's backward, with the rows a block
    shrunk so that its shared partial rows fit."""
    sms = 132
    threads, rows, blocks = sfu.norm_bwd_plan(R, N, esize, aligned, sms,
                                              parts)
    assert threads == sfu.norm_plan(N, esize, aligned)
    assert 1 <= blocks <= -(-R // rows)
    shared = max(1, parts) * N
    if threads:
        assert rows == 1 or shared <= sfu.BWD_SMEM_FLOATS
        assert rows * threads <= sfu.MAX_THREADS
    elif N <= sfu.WARP_ROW_MAX:
        assert 1 <= rows <= sfu.BWD_WARP_ROWS
        assert rows * shared <= sfu.BWD_SMEM_FLOATS
    else:
        assert rows == 1
    # one partial row (rmsnorm's) gives rmsnorm's plan
    if parts <= 1:
        assert (threads, rows, blocks) == sfu.norm_bwd_plan(R, N, esize,
                                                            aligned, sms)


def test_layernorm_bwd_plan_at_whisper_and_nemotron_training_rows():
    # whisper-medium: 4 x 512 rows of 1024 bf16, gamma and beta: the warp
    # kernel, 6 rows a block (two shared rows each, 48 KB), two blocks an
    # SM; nemotron-4-15b's 6144: the vector kernel, 384 threads a row, one
    # row a block (two rows of 6144 floats are 48 KB), one block an SM
    assert sfu.norm_bwd_plan(2048, 1024, 2, True, 132, 2) == (0, 6, 264)
    assert sfu.norm_bwd_plan(2048, 6144, 2, True, 132, 2) == (384, 1, 132)
    assert sfu.column_sum_plan(264, 1024) == (4, 32)
    assert sfu.column_sum_plan(132, 6144) == (4, 32)


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
