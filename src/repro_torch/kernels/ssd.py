"""ssd: the Mamba-2 chunked SSD scan on the H100.

Replaces the Pallas TPU kernel ``_ssd_kernel`` (``src/repro/kernels/ssd.py``)
and the layout work of the reference's ``ops.ssd`` around it with the
hand-written CUDA kernels of ``csrc/ssd.cu``, laid out by ``ssd_plan``:
one carries the state through the chunks in series, spread over blocks
of 32 state columns, and writes the state entering each chunk; the
other computes every chunk's output in parallel.  The kernels read x
``(B, S, H, P)`` and b, c ``(B, S, G, N)`` where they lie
(head ``h`` reads group ``h // (H / G)``; batch and position strides are
arguments, so a slice of a wider tensor needs no copy), mask the
positions past the true length inside, start from an initial state when
one is given, and write the state after the last position.  bf16 inputs
run every product on the tensor cores, with the three fp32 operands (the
decayed B, the masked C Bᵀ, the carried state) split into a bf16 high and
low part; fp32 inputs run on fp32 FMA.  The reference's kernel returns no
state (its ``ops.ssd`` gives ``(y, None)``); this one does, so prefill
needs no second pass.

Bound on the card at mamba2-2.7b's prefill (4 x 512 x 80 heads of 64,
state 128, chunk 128): 9.427 GFLOP over the causal pairs against 54.13
MB; in bf16 on the tensor cores the bytes bound it (0.0162 ms), in fp32
the operations at the FMA peak (0.1407 ms); see the source note.

Under autograd (grad mode on, an operand requiring grad) ``ssd`` runs as
``_Ssd``: the forward keeps its scratch (the state entering each chunk)
and the backward is ``ssd_bwd``, three more kernels of ``csrc/ssd.cu``
(``ssd_bwd_plan``): a reverse recurrence carrying the state's gradient
back through the chunks, a kernel per (chunk, head block, batch) for dx,
da and each head block's db and dc, and a fixed-order sum of those over
each group's head blocks; deterministic.  bf16 inputs run every product
on the tensor cores, as the forward does, with the fp32 operands (C ∘
exp(acs), the masked C Bᵀ and dY Xᵀ, the state's gradient, the entering
state) split into a bf16 high and low part, and a block takes several
heads of a group in series, so C and B are staged once for them and
their db and dc are summed before they reach memory; fp32 inputs run
one head a block on fp32 FMA.

A tensor on the CPU goes to the plain versions ``ref.ssd_plain`` and
``ref.ssd_bwd``; a CUDA tensor goes to the kernels, or the call raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build, ref

# what the kernel is built for: chunk length, head dim P, state dim N
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P,) * 8 + (_I,) * 9 + (_LL,) * 8 + (_P,)
_BWD_ARGS = (_P,) * 15 + (_I,) * 11 + (_LL,) * 10 + (_P,)
_SIGNATURES = {"ssd_f32": _ARGS, "ssd_bf16": _ARGS,
               "ssd_bwd_f32": _BWD_ARGS, "ssd_bwd_bf16": _BWD_ARGS}
# state columns a block of the state kernel carries (csrc/ssd.cu's QN)
STATE_COLS = 32
# the backward's chunk kernels (csrc/ssd.cu): 256 threads (fp32: 16 x 16,
# tiles of 16-row blocks; bf16: 8 warps of 16 rows); the bf16 kernel's
# shared memory (CHUNK_MMA_SMEM) and the most heads a block of it takes;
# the group sum's threads a block; shared memory a block may use on the
# H100 (227 KB)
BWD_THREADS, GROUP_SUM_THREADS, SMEM_MAX = 256, 256, 232448
BWD_MMA_SMEM, BWD_MAX_HEADS = 211216, 16


@dataclass(frozen=True)
class SsdPlan:
    """How ``ssd`` lays out one call.  The scan runs one block per
    (chunk, head, batch): ``grid`` (x, y, z); the state kernel one block
    per ``STATE_COLS`` columns of a (head, batch)'s state: ``state_grid``.
    ``scratch_bytes``: the fp32 state entering every (batch, chunk,
    head), written by the state kernel and read by the scan."""
    chunk: int
    chunks: int
    grid: tuple[int, int, int]
    state_grid: tuple[int, int, int]
    scratch_bytes: int


def ssd_plan(B: int, S: int, H: int, P: int, N: int, chunk: int) -> SsdPlan:
    """The launch plan of ``ssd`` over x (B, S, H, P) with state N:
    chunks of ``min(chunk, S)`` positions (the last one shorter when they
    do not divide S), at least one position long."""
    L = min(chunk, max(S, 1))
    chunks = -(-S // L)
    return SsdPlan(chunk=L, chunks=chunks, grid=(chunks, H, B),
                   state_grid=(-(-N // STATE_COLS), H, B),
                   scratch_bytes=4 * B * chunks * H * P * N)


@dataclass(frozen=True)
class SsdBwdPlan:
    """How ``ssd_bwd`` lays out one call.  The reverse state kernel runs
    one block per ``STATE_COLS`` columns of a (head, batch)'s state
    (``state_grid``); the chunk kernel one block per (chunk, head block,
    batch) (``grid``), a head block being ``heads`` heads of one group
    taken in series (1 for fp32), on tiles of ``rows`` rows in
    ``smem_bytes`` of shared memory; the group sum one thread per element of db (and of dc: ``group_grid``
    y = 2).  ``scratch_bytes``: the gradient of the state leaving every
    (batch, chunk, head) and each head block's fp32 db and dc."""
    chunk: int
    chunks: int
    state_grid: tuple[int, int, int]
    grid: tuple[int, int, int]
    heads: int
    rows: int
    smem_bytes: int
    group_grid: tuple[int, int]
    scratch_bytes: int


def bwd_heads(B: int, chunks: int, H: int, G: int, sms: int) -> int:
    """Heads a block of the bf16 chunk kernel takes in series: the count
    up to ``BWD_MAX_HEADS`` (and the group's heads) that gives the busiest
    SM the fewest head-chunks, one block an SM at a time (rounds of
    ``sms`` blocks times heads a block), the most heads where several tie
    (C and B staged once for more heads, less scratch)."""
    rep = H // G

    def cost(k: int) -> int:
        return -(-B * chunks * G * -(-rep // k) // sms) * k
    return min(range(1, min(rep, BWD_MAX_HEADS) + 1),
               key=lambda k: (cost(k), -k))


def ssd_bwd_plan(B: int, S: int, H: int, P: int, G: int, N: int,
                 chunk: int, sms: int, bf16: bool = True) -> SsdBwdPlan:
    """The launch plan of ``ssd_bwd`` on a card of ``sms`` SMs: the
    forward's chunks (``ssd_plan``).  bf16: tiles of the chunk rounded up
    to 16 rows in the tensor-core kernel's fixed shared memory, with
    ``bwd_heads`` heads a block; fp32: one head a block, tiles of 16, 32,
    64 or 128 rows in the shared memory ``bwd_smem_floats`` of csrc/ssd.cu
    computes for the kernel's largest head dim and state (C then B, B then
    R and Z as packed triangles beside G or the entering state, X, dY, and
    per-row sums)."""
    fwd = ssd_plan(B, S, H, P, N, chunk)
    if bf16:
        heads = bwd_heads(B, fwd.chunks, H, G, sms)
        rows = -(-fwd.chunk // 16) * 16
        smem = BWD_MMA_SMEM
    else:
        heads, rows = 1, 16
        while rows < fwd.chunk:
            rows *= 2
        ldn, ldp = MAX_STATE + 1, MAX_HEAD_DIM + 1
        tri = rows * (rows + 1) // 2
        lo = max(tri, MAX_HEAD_DIM * ldn)
        smem = 4 * (rows * ldn + max(rows * ldn, lo + tri) + 2 * rows * ldp
                    + 20 * MAX_CHUNK + BWD_THREADS // 32)
    hblocks = -(-(H // G) // heads)
    elems = B * S * G * N
    return SsdBwdPlan(
        chunk=fwd.chunk, chunks=fwd.chunks, state_grid=fwd.state_grid,
        grid=(fwd.chunks, G * hblocks, B), heads=heads, rows=rows,
        smem_bytes=smem,
        group_grid=(-(-elems // GROUP_SUM_THREADS), 2),
        scratch_bytes=fwd.scratch_bytes + 2 * 4 * B * S * G * hblocks * N)


def _check(x, a, b, c, chunk, initial_state) -> None:
    _build.refuse_dtensor("ssd", x, a, b, c, initial_state)
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"ssd needs x (B,S,H,P), a (B,S,H) and b, c "
                         f"(B,S,G,N), got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if tuple(a.shape) != (B, S, H) or tuple(b.shape[:2]) != (B, S):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not group over {G} state groups")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd takes float32 or bfloat16 x, got {x.dtype}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    tensors = [("a", a), ("b", b), ("c", c)]
    if initial_state is not None:
        if initial_state.dtype != torch.float32 or \
                tuple(initial_state.shape) != (B, H, P, N):
            raise ValueError(f"initial_state must be float32 {(B, H, P, N)}, "
                             f"got {initial_state.dtype} "
                             f"{tuple(initial_state.shape)}")
        if not initial_state.is_contiguous():
            raise ValueError("ssd: initial_state must be contiguous")
        tensors.append(("initial_state", initial_state))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
    # batch and position dims may be strided; the rest must be packed
    def packed(t, inner):
        return all(t.stride(d) == want for d, want in inner
                   if t.shape[d] > 1)

    if not (packed(x, ((3, 1), (2, P))) and packed(a, ((2, 1),))
            and all(packed(t, ((3, 1), (2, N))) for t in (b, c))):
        raise ValueError("ssd reads x's (H, P), a's H and b/c's (G, N) "
                         "packed; only the batch and position dims may be "
                         "strided")


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = 128, initial_state: torch.Tensor | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD over ``chunk``-long chunks: returns (y (B, S, H, P) in
    x's dtype, the fp32 state (B, H, P, N) after the last position).

    x, b, c fp32 or bf16 (one dtype), a and ``initial_state`` fp32; see
    ``ref.ssd_scan`` for the function.  The chunk shapes the arithmetic
    (not the function beyond fp32 rounding); the kernel takes chunks of
    ``min(chunk, S)`` positions, at most 128.
    """
    _check(x, a, b, c, chunk, initial_state)
    if x.device.type == "cpu":
        return ref.ssd_plain(x, a, b, c, chunk=chunk,
                             initial_state=initial_state)
    _on_card(x, b, chunk)
    if _build.needs_grad(x, a, b, c, initial_state):
        y, final = _Ssd.apply(x, a, b, c, initial_state, chunk)
    else:
        y, final, _ = _forward(x, a, b, c, chunk, initial_state)
    if final.numel():
        ssd.launches += 1
    return y, final


def ssd_states(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *, chunk: int = 128,
               initial_state: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """``ssd``'s forward kernels outside autograd, returning also their
    scratch, the fp32 state entering each (batch, chunk, head) (flat, as
    ``ssd_bwd`` takes it; None where nothing was launched): what ``_Ssd``
    keeps for the backward.  On the CPU the plain version, with no
    scratch."""
    _check(x, a, b, c, chunk, initial_state)
    if x.device.type == "cpu":
        return (*ref.ssd_plain(x, a, b, c, chunk=chunk,
                               initial_state=initial_state), None)
    _on_card(x, b, chunk)
    out = _forward(x, a, b, c, chunk, initial_state)
    if out[1].numel():
        ssd.launches += 1
    return out


def _on_card(x: torch.Tensor, b: torch.Tensor, chunk: int) -> None:
    """Raise unless x lies on the card and the kernels are built for the
    chunk, head dim and state."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda (or cpu), not {x.device}")
    P, N = x.shape[3], b.shape[3]
    if chunk > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd's kernel is built for chunk <= {MAX_CHUNK}, "
                         f"P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got chunk "
                         f"{chunk}, P {P}, N {N}")


def _forward(x, a, b, c, chunk, initial_state):
    """The forward kernels on checked CUDA operands: (y, final state, the
    scratch of entering states, or None where nothing was launched)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if final.numel() == 0:
        return y, final, None
    plan = ssd_plan(B, S, H, P, N, chunk)
    states = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                         device=x.device)
    lib = _build.load("ssd", _SIGNATURES)
    fn = lib.ssd_f32 if x.dtype == torch.float32 else lib.ssd_bf16
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 initial_state.data_ptr() if initial_state is not None
                 else None, y.data_ptr(), final.data_ptr(),
                 states.data_ptr(), B, S, H, P, G, N, plan.chunk,
                 plan.chunks, plan.state_grid[0],
                 x.stride(0), x.stride(1), a.stride(0), a.stride(1),
                 b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd")
    return y, final, states


class _Ssd(torch.autograd.Function):
    """ssd on the card with its backward kernels: the forward keeps the
    state entering each chunk (its own scratch, 4 B x chunks x H x P x N
    bytes), so that the backward need not carry the state forward again."""

    @staticmethod
    def forward(ctx, x, a, b, c, initial_state, chunk):
        y, final, states = _forward(x, a, b, c, chunk, initial_state)
        ctx.save_for_backward(x, a, b, c, initial_state, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, a, b, c, initial_state, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, da, db, dc, dinit = ssd_bwd(
            x, a, b, c, dy.contiguous(), chunk=ctx.chunk,
            initial_state=initial_state, dfinal=dfinal, states=states)
        return dx, da, db, dc, dinit, None


def ssd_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, dy: torch.Tensor, *, chunk: int = 128,
            initial_state: torch.Tensor | None = None,
            dfinal: torch.Tensor | None = None,
            states: torch.Tensor | None = None):
    """``ssd``'s backward: ``(dx, da, db, dc, d initial_state)`` from the
    forward's operands, dy (y's shape and dtype), the final state's
    gradient ``dfinal`` (fp32 (B, H, P, N), or None: zero) and, on the
    card, ``states``, the forward's scratch (``ssd_states``).  dx in x's
    dtype, da fp32, db and dc fresh (B, S, G, N) tensors in b's dtype, the
    initial state's gradient fp32 where one was given (else None).  See
    ``ref.ssd_bwd`` for the function; deterministic (no atomics)."""
    _check(x, a, b, c, chunk, initial_state)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"ssd_bwd: dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if dfinal is not None and (dfinal.dtype != torch.float32 or tuple(
            dfinal.shape) != (B, H, P, N) or dfinal.device != x.device
            or not dfinal.is_contiguous()):
        raise ValueError(f"ssd_bwd: dfinal must be a contiguous float32 "
                         f"{(B, H, P, N)} on {x.device}")
    if x.device.type == "cpu":
        return ref.ssd_bwd(x, a, b, c, dy, chunk=chunk,
                           initial_state=initial_state, dfinal=dfinal)
    _on_card(x, b, chunk)
    plan = ssd_bwd_plan(B, S, H, P, G, N, chunk, _build.sm_count(x.device),
                        bf16=x.dtype == torch.bfloat16)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    da = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    db, dc = (torch.empty((B, S, G, N), dtype=b.dtype, device=x.device)
              for _ in range(2))
    dinit = None if initial_state is None else torch.empty(
        (B, H, P, N), dtype=torch.float32, device=x.device)
    if B * H * P * N == 0:     # no state: the forward launched nothing
        return dx.zero_(), da.zero_(), db.zero_(), dc.zero_(), dinit
    n_states = B * plan.chunks * H * P * N     # the forward's scratch
    if states is None or states.dtype != torch.float32 or \
            states.numel() != n_states or states.device != x.device or \
            not states.is_contiguous():
        raise ValueError(f"ssd_bwd: states must be the forward's scratch, "
                         f"{n_states} contiguous float32 (ssd_states)")
    dstates = torch.empty(n_states, dtype=torch.float32, device=x.device)
    dbh, dch = (torch.empty((B, S, plan.grid[1], N), dtype=torch.float32,
                            device=x.device) for _ in range(2))
    lib = _build.load("ssd", _SIGNATURES)
    fn = lib.ssd_bwd_f32 if x.dtype == torch.float32 else lib.ssd_bwd_bf16
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 dy.data_ptr(), states.data_ptr(),
                 None if dfinal is None else dfinal.data_ptr(),
                 dx.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                 None if dinit is None else dinit.data_ptr(),
                 dstates.data_ptr(), dbh.data_ptr(), dch.data_ptr(),
                 B, S, H, P, G, N, plan.chunk, plan.chunks,
                 plan.state_grid[0], plan.heads,
                 int(initial_state is not None),
                 x.stride(0), x.stride(1), a.stride(0), a.stride(1),
                 b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                 dy.stride(0), dy.stride(1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_bwd")
    ssd_bwd.launches += 1
    return dx, da, db, dc, dinit


ssd.launches = 0
ssd_bwd.launches = 0
