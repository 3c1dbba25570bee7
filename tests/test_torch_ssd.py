"""The port's SSD functions against the JAX package's.

On the CPU ``ops.ssd`` and the ``ssd`` wrapper run the plain PyTorch
versions (``ref.ssd_plain``: the chunked algorithm or the recurrence, as
the reference chooses), which are held against ``ssd_pallas`` in
interpret mode, the reference's ``ops.ssd`` under
``set_kernel_mode("pallas")`` and its jnp oracles, on the same seeded
numpy inputs, with the tolerances of tests/test_kernels.py.  The CUDA
kernels are held against the plain versions on the card in
test_torch_cuda.py; their bf16 arithmetic (every fp32 operand of a
tensor-core product split into a bf16 high and low part) is emulated in
plain torch at the end of this file and held to the card's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_pallas
from repro_torch.kernels import ops, ref, ssd

# (B, S, H, P, G, N): the reference's sweep (tests/test_kernels.py)
SSD_SHAPES = [(2, 128, 4, 16, 2, 8), (1, 64, 2, 8, 1, 4),
              (2, 256, 8, 32, 2, 16)]


def _inputs(shape, seed):
    """x ~ N(0, 1), a = -|N(0, 0.1²)|, b and c ~ N(0, 0.3²), float32
    numpy, as the reference's ``_ssd_inputs`` draws them."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    a = -np.abs(rng.normal(size=(B, S, H))) * 0.1
    b = rng.normal(size=(B, S, G, N)) * 0.3
    c = rng.normal(size=(B, S, G, N)) * 0.3
    return [v.astype(np.float32) for v in (x, a, b, c)]


def _t(*arrays):
    return [torch.from_numpy(v) for v in arrays]


def _j(*arrays):
    return [jnp.asarray(v) for v in arrays]


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_matches_the_pallas_kernel(shape, chunk):
    """ops.ssd against ``ssd_pallas`` (interpret mode) on the heads
    flattened and the groups repeated as the reference's test does."""
    B, S, H, P, G, N = shape
    x, a, b, c = _inputs(shape, 1)
    rep = H // G
    xf = np.moveaxis(x, 2, 1).reshape(B * H, S, P)
    af = np.moveaxis(a, 2, 1).reshape(B * H, S)
    bf, cf = (np.repeat(v, rep, axis=2).transpose(0, 2, 1, 3)
              .reshape(B * H, S, N) for v in (b, c))
    want = ssd_pallas(*_j(xf, af, bf, cf), chunk=chunk, interpret=True)
    want = np.asarray(want).reshape(B, H, S, P).transpose(0, 2, 1, 3)
    y, state = ops.ssd(*_t(x, a, b, c), chunk=chunk)
    _close(y, want, 5e-5)
    _, want_state = jref.ssd_scan(*_j(x, a, b, c))
    _close(state, want_state, 3e-4)


def test_ssd_tail_matches_the_reference_ops_with_pallas():
    """S = 100 over chunks of 64: the reference pads and masks the tail
    chunk inside its kernel; the port's plain side runs the recurrence."""
    shape = (1, 100, 2, 8, 1, 4)
    x, a, b, c = _inputs(shape, 2)
    jops.set_kernel_mode("pallas")
    try:
        want, none = jops.ssd(*_j(x, a, b, c), chunk=64)
    finally:
        jops.set_kernel_mode("auto")
    assert none is None          # the reference's kernel path has no state
    y, state = ops.ssd(*_t(x, a, b, c), chunk=64)
    _close(y, want, 5e-5)
    _close(state, jref.ssd_scan(*_j(x, a, b, c))[1], 5e-5)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunked_matches_scan(shape, chunk):
    """The port's chunked algorithm against the reference's recurrence and
    the port's recurrence against the reference's chunked algorithm, in y
    and the final state (tests/test_kernels.py's 3e-4)."""
    x, a, b, c = _inputs(shape, 3)
    want_y, want_s = jref.ssd_scan(*_j(x, a, b, c))
    got_y, got_s = ref.ssd_chunked(*_t(x, a, b, c), chunk=chunk)
    _close(got_y, want_y, 3e-4)
    _close(got_s, want_s, 3e-4)
    want_y, want_s = jref.ssd_chunked(*_j(x, a, b, c), chunk=chunk)
    got_y, got_s = ref.ssd_scan(*_t(x, a, b, c))
    _close(got_y, want_y, 3e-4)
    _close(got_s, want_s, 3e-4)


@pytest.mark.parametrize("chunk", [16, 32, 100])
def test_ssd_initial_state_matches_the_reference(chunk):
    """Both sides agree given the same initial state, and a prefix run to
    its final state, then the rest from that state, equals the whole run.
    S = 100 is a multiple of none of these chunks that it exceeds, so the
    plain side runs the recurrence (the next test takes the chunked
    algorithm)."""
    shape = (2, 100, 4, 16, 2, 8)
    x, a, b, c = _inputs(shape, 5)
    s0 = np.random.default_rng(6).normal(size=(2, 4, 16, 8)).astype(
        np.float32)
    want_y, want_s = jref.ssd_scan(*_j(x, a, b, c),
                                   initial_state=jnp.asarray(s0))
    y, s = ops.ssd(*_t(x, a, b, c), chunk=chunk,
                   initial_state=torch.from_numpy(s0))
    _close(y, want_y, 3e-4)
    _close(s, want_s, 3e-4)
    # the prefix's final state carries the rest
    t = torch.from_numpy
    y1, s1 = ops.ssd(t(x[:, :40]), t(a[:, :40]), t(b[:, :40]), t(c[:, :40]),
                     chunk=chunk, initial_state=t(s0))
    y2, s2 = ops.ssd(t(x[:, 40:]), t(a[:, 40:]), t(b[:, 40:]), t(c[:, 40:]),
                     chunk=chunk, initial_state=s1)
    _close(torch.cat([y1, y2], dim=1), want_y, 3e-4)
    _close(s2, want_s, 3e-4)


def test_ssd_chunked_initial_state_matches_the_reference():
    shape = (2, 128, 4, 16, 2, 8)
    x, a, b, c = _inputs(shape, 7)
    s0 = np.random.default_rng(8).normal(size=(2, 4, 16, 8)).astype(
        np.float32)
    want_y, want_s = jref.ssd_chunked(*_j(x, a, b, c), chunk=32,
                                      initial_state=jnp.asarray(s0))
    y, s = ops.ssd(*_t(x, a, b, c), chunk=32,
                   initial_state=torch.from_numpy(s0))
    _close(y, want_y, 3e-4)
    _close(s, want_s, 3e-4)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_decode_steps_match_the_scan(groups):
    B, S, H, P, N = 1, 40, 2, 8, 4
    x, a, b, c = _inputs((B, S, H, P, groups, N), 9)
    want, want_state = jref.ssd_scan(*_j(x, a, b, c))
    state = torch.zeros((B, H, P, N))
    jstate = jnp.zeros((B, H, P, N), jnp.float32)
    outs = []
    xt, at, bt, ct = _t(x, a, b, c)
    for t in range(S):
        y, state = ops.ssd_decode_step(xt[:, t], at[:, t], bt[:, t],
                                       ct[:, t], state)
        jy, jstate = jops.ssd_decode_step(*_j(x[:, t], a[:, t], b[:, t],
                                              c[:, t]), jstate)
        _close(y, jy, 5e-5)
        outs.append(y)
    _close(torch.stack(outs, 1), want, 5e-5)
    _close(state, want_state, 5e-5)
    _close(state, jstate, 5e-5)


def test_ssd_wrapper_on_the_cpu_is_the_plain_version():
    """The wrapper's CPU path is ``ref.ssd_plain`` bit for bit, counts no
    launch, and reads strided views like packed tensors."""
    shape = (2, 96, 4, 16, 2, 8)
    x, a, b, c = _t(*_inputs(shape, 10))
    before = ssd.launches
    for chunk in (32, 96, 128):
        got = ssd(x, a, b, c, chunk=chunk)
        want = ref.ssd_plain(x, a, b, c, chunk=chunk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ssd.launches == before
    # b and c as slices of one (B, S, 3 G N) tensor, x of a longer one
    bc = torch.cat([torch.zeros(2, 96, 16), b.reshape(2, 96, 16),
                    c.reshape(2, 96, 16)], dim=-1)
    xl = torch.cat([x, torch.full((2, 8, 4, 16), float("nan"))], dim=1)
    bv = bc[..., 16:32].reshape(2, 96, 2, 8)
    cv = bc[..., 32:].reshape(2, 96, 2, 8)
    assert not bv.is_contiguous() and not xl[:, :96].is_contiguous()
    got = ssd(xl[:, :96], a, bv, cv, chunk=32)
    want = ssd(x, a, b, c, chunk=32)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_serve():
    x, a, b, c = _t(*_inputs((1, 16, 4, 8, 2, 4), 11))
    with pytest.raises(ValueError, match="group"):
        ssd(x, a, b[:, :, :1].expand(1, 16, 3, 4).contiguous(),
            c[:, :, :1].expand(1, 16, 3, 4).contiguous())
    with pytest.raises(ValueError):
        ssd(x, a[:, :8], b, c)
    with pytest.raises(TypeError):
        ssd(x.double(), a, b.double(), c.double())
    with pytest.raises(TypeError):
        ssd(x.bfloat16(), a, b, c)
    with pytest.raises(TypeError):
        ssd(x, a.bfloat16(), b, c)
    with pytest.raises(ValueError, match="packed"):
        ssd(x.transpose(2, 3).contiguous().transpose(2, 3), a, b, c)
    with pytest.raises(ValueError, match="initial_state"):
        ssd(x, a, b, c, initial_state=torch.zeros(1, 4, 8, 5))
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, a, b, c, chunk=0)
    meta = [t.to("meta") for t in (x, a, b, c)]
    with pytest.raises(ValueError, match="cuda"):
        ssd(*meta)


def test_ssd_bf16_on_the_cpu_computes_in_fp32_and_rounds_once():
    x, a, b, c = _inputs((1, 48, 4, 16, 1, 8), 12)
    xb, bb, cb = (torch.from_numpy(v).bfloat16() for v in (x, b, c))
    y, s = ops.ssd(xb, torch.from_numpy(a), bb, cb, chunk=48)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_y, want_s = jref.ssd_scan(
        *_j(xb.float().numpy(), a, bb.float().numpy(), cb.float().numpy()))
    # one bf16 ulp: both round an fp32 result once
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(jnp.asarray(want_y).astype(jnp.bfloat16), np.float32),
        rtol=2 ** -7, atol=1e-6)
    _close(s, want_s, 5e-5)


# ---------------------------------------------------------------------------
# The arithmetic of csrc/ssd.cu's bf16 path, emulated in plain torch on the
# CPU: the three phases (each chunk's state, the pass carrying the state
# across chunks, each chunk's output), with every fp32 operand that enters
# a bf16 tensor-core product either split into a bf16 high and low part,
# as the kernel does, or rounded once.

# mamba2-2.7b's head and state widths at 16 heads: 4 chunks of 128
SPLIT_SHAPE = (2, 512, 16, 64, 1, 128)


def _mamba_inputs(shape, seed):
    """x ~ N(0, 1), b and c ~ N(0, 0.3²) as bf16; a fp32 as mamba2 makes
    it (tests/test_torch_cuda.py's ``_ssd_inputs``): -exp(A_log) dt with
    A_log's 1..16 over the heads and dt in [0.005, 0.1]; an initial state
    ~ N(0, 1)."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.005, 0.1, size=(B, S, H))
    a = (-np.linspace(1.0, 16.0, H)[None, None] * dt).astype(np.float32)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    b = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x, b, c = (torch.from_numpy(v).bfloat16() for v in (x, b, c))
    return x, torch.from_numpy(a), b, c, torch.from_numpy(s0)


def _bf16_operand(v, split):
    """The fp32 ``v`` as the kernel hands it to a bf16 product: (hi, lo)
    with lo = bf16(v - hi), or one rounding (hi, 0)."""
    hi = v.bfloat16().float()
    return hi, ((v - hi).bfloat16().float() if split else torch.zeros_like(v))


OPERANDS = ("bw", "r", "s")  # B o w, (C B^T) o L, the carried state


def _emulate_ssd_kernel(x, a, b, c, *, chunk, initial_state=None,
                        rounded_once=()):
    """csrc/ssd.cu's bf16 path: (y in bf16, fp32 final state).  Products
    of bf16 operands are exact in fp32, so each tensor-core product is an
    fp32 einsum of the bf16 values; the fp32 operands named in
    ``rounded_once`` (of ``OPERANDS``) are rounded to bf16 once instead of
    split."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    xf, bf, cf = (v.float() for v in (x, b, c))
    bf, cf = (v.repeat_interleave(H // G, dim=2) for v in (bf, cf))
    L = min(chunk, S)
    starts = range(0, S, L)
    # A. each chunk's state: D = X^T (B o w), B o w as hi + lo
    deltas, decays = [], []
    for c0 in starts:
        sl = slice(c0, c0 + L)
        acs = torch.cumsum(a[:, sl], dim=1)                   # (B, l, H)
        w = torch.exp(acs[:, -1:] - acs)
        hi, lo = _bf16_operand(bf[:, sl] * w[..., None],
                               "bw" not in rounded_once)
        deltas.append(torch.einsum("bshp,bshn->bhpn", xf[:, sl], hi)
                      + torch.einsum("bshp,bshn->bhpn", xf[:, sl], lo))
        decays.append(torch.exp(acs[:, -1]))                  # (B, H)
    # B. the state entering each chunk, and the last one
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B, H, P, N)))
    entering = []
    for delta, decay in zip(deltas, decays):
        entering.append(state)
        state = decay[..., None, None] * state + delta
    # C. y = exp(acs) o (C S^T) + ((C B^T) o L) X, S and R as hi + lo
    ys = []
    for c0, s_in in zip(starts, entering):
        sl = slice(c0, c0 + L)
        l = xf[:, sl].shape[1]
        acs = torch.cumsum(a[:, sl], dim=1)
        sh, slo = _bf16_operand(s_in, "s" not in rounded_once)
        y = (torch.einsum("bthn,bhpn->bthp", cf[:, sl], sh)
             + torch.einsum("bthn,bhpn->bthp", cf[:, sl], slo))
        y = y * torch.exp(acs)[..., None]
        cb = torch.einsum("bthn,bshn->bhts", cf[:, sl], bf[:, sl])
        acs_h = acs.transpose(1, 2)                           # (B, H, l)
        seg = acs_h[..., :, None] - acs_h[..., None, :]
        causal = torch.ones(l, l, dtype=torch.bool).tril()
        r = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)) * cb,
                        0.0)
        rh, rl = _bf16_operand(r, "r" not in rounded_once)
        y = y + torch.einsum("bhts,bshp->bthp", rh, xf[:, sl]) \
            + torch.einsum("bhts,bshp->bthp", rl, xf[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def _meets_card_tolerance(got, want):
    """tests/test_torch_cuda.py's ``_ssd_close`` for bf16: y within 2^-7
    relative and 1e-4 absolute, the fp32 state within 1e-4."""
    y_ok = torch.allclose(got[0].float(), want[0].float(), rtol=2 ** -7,
                          atol=1e-4)
    s_ok = torch.allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
    return y_ok, s_ok


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_ssd_kernel_split_arithmetic_meets_the_card_tolerance(with_init):
    """The kernel's bf16 arithmetic, emulated at mamba2-2.7b's head and
    state widths over 4 chunks, meets the card tests' bf16 tolerances
    against ``ref.ssd_plain``, from zero and from an initial state."""
    x, a, b, c, s0 = _mamba_inputs(SPLIT_SHAPE, 60)
    init = s0 if with_init else None
    got = _emulate_ssd_kernel(x, a, b, c, chunk=128, initial_state=init)
    want = ref.ssd_plain(x, a, b, c, chunk=128, initial_state=init)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert _meets_card_tolerance(got, want) == (True, True)


@pytest.mark.parametrize("once", OPERANDS)
def test_ssd_kernel_one_rounding_of_any_operand_fails_the_card_check(once):
    """Why the kernel splits its fp32 operands: B o w (phase A's operand)
    rounded to bf16 once, the others split, puts the state past the
    card's 1e-4 by over 10x; R or the carried state rounded once puts y
    past 2^-7.  Split, all three meet both (the test above)."""
    x, a, b, c, _ = _mamba_inputs(SPLIT_SHAPE, 60)
    got = _emulate_ssd_kernel(x, a, b, c, chunk=128, rounded_once=(once,))
    want = ref.ssd_plain(x, a, b, c, chunk=128)
    y_ok, s_ok = _meets_card_tolerance(got, want)
    if once == "bw":
        assert not s_ok
        assert (got[1] - want[1]).abs().max().item() > 1e-3
    else:
        assert s_ok and not y_ok
