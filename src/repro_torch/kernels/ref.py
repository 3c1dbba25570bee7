"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro.kernels.ref``.  Each function computes what its
hand-written CUDA kernel computes, in fp32, written out step by step:
the wrappers in ``flex_gemm.py`` / ``sfu.py`` / ``flash_attention.py``
use these for tensors on the CPU, and the tests and ``chip_smoke.py``
hold the kernels against them.  On the card they run only where a caller
asks for them by name (``plain=True`` of ``ops`` and the model code).

Numerics follow the reference: GELU is the tanh form (``jax.nn.gelu``'s
default and ``NonLinear.GELU``), layernorm uses the population variance,
rmsnorm divides the sum of squares by the true width.  Attention follows
the Pallas kernel where it and the jnp oracle differ (see
``mha_attention``).  The SSD functions
(``ssd_scan``, ``ssd_chunked``, ``ssd_decode_step``) copy the
reference's contract, ``(B, S, H, P)`` heads over ``(B, S, G, N)``
groups returning ``(y, final_state)``; ``ssd_plain`` is the choice
between the first two that the reference's ``ops.ssd`` makes, except
that past ``SSD_PLAIN_SEGMENT`` positions it runs the chunked one a
segment at a time (``ssd_chained``), for memory alone.
"""

from __future__ import annotations

import math

import torch

EPILOGUES = ("none", "bias", "gelu", "relu", "relu2", "silu",
             "bias_gelu", "bias_relu", "bias_relu2", "bias_silu")
ACTIVATIONS = ("gelu", "relu", "relu2", "silu")

_GELU_C = math.sqrt(2.0 / math.pi)


# ---------------------------------------------------------------------- act

def gelu_rows(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    y = 0.5 * x32 * (1.0 + torch.tanh(_GELU_C * (x32 + 0.044715 * x32 ** 3)))
    return y.to(x.dtype)


def relu_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.float(), 0.0).to(x.dtype)


def relu2_rows(x: torch.Tensor) -> torch.Tensor:
    r = torch.clamp_min(x.float(), 0.0)
    return (r * r).to(x.dtype)


def silu_rows(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 / (1.0 + torch.exp(-x32))).to(x.dtype)


ACT_FN = {"gelu": gelu_rows, "relu": relu_rows, "relu2": relu2_rows,
          "silu": silu_rows}


# --------------------------------------------------------------------- gemm

def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
         epilogue: str = "none", c: torch.Tensor | None = None
         ) -> torch.Tensor:
    """``epi(A @ B + c + bias)`` in fp32, returned in A's dtype.  ``c`` is
    the accumulator input (the runtime's OUT tile when ``accumulate`` is
    set), added before the epilogue as ``runtime.py`` does."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    out = a.float() @ b.float()
    if c is not None:
        out = c.float() + out
    if epilogue.startswith("bias"):
        out = out + bias.float()
    act = epilogue.split("_")[-1]
    if act in ACT_FN:
        out = ACT_FN[act](out)
    return out.to(a.dtype)


# ---------------------------------------------------------------------- sfu

def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def layernorm_rows(x: torch.Tensor, gamma: torch.Tensor | None = None,
                   beta: torch.Tensor | None = None, eps: float = 1e-5
                   ) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    d = x32 - mu
    var = (d * d).mean(dim=-1, keepdim=True)     # population variance
    y = d * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def layernorm_stats(x: torch.Tensor, eps: float = 1e-5
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's mean and ``rsqrt(var + eps)`` (population variance) in
    fp32: what the forward kernels keep for the backward."""
    x32 = x.float()
    mu = x32.mean(dim=-1)
    d = x32 - mu[:, None]
    return mu, torch.rsqrt((d * d).mean(dim=-1) + eps)


def layernorm_bwd(x: torch.Tensor, gamma: torch.Tensor | None,
                  beta: torch.Tensor | None, mean: torch.Tensor,
                  rstd: torch.Tensor, dy: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor | None,
                             torch.Tensor | None]:
    """The backward kernel's formula in fp32: with x̂ = (x - mean)·rstd and
    g = γ dy (dy without gamma), ``dx = rstd (g - mean(g) - x̂ mean(g x̂))``
    (x's dtype), ``dγ = Σ_rows dy x̂`` and ``dβ = Σ_rows dy`` (fp32; None
    where the forward had no gamma or no beta)."""
    x32, d = x.float(), dy.float()
    r = rstd.float()[:, None]
    xh = (x32 - mean.float()[:, None]) * r
    gd = d * gamma.float() if gamma is not None else d
    dx = r * (gd - gd.mean(dim=-1, keepdim=True)
              - xh * (gd * xh).mean(dim=-1, keepdim=True))
    dgamma = (d * xh).sum(0) if gamma is not None else None
    dbeta = d.sum(0) if beta is not None else None
    return dx.to(x.dtype), dgamma, dbeta


def rmsnorm_rows(x: torch.Tensor, gamma: torch.Tensor | None = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * gamma`` in fp32, in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma.float()
    return y.to(x.dtype)


def rmsnorm_rstd(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Each row's ``rsqrt(mean(x²) + eps)`` in fp32: what the forward
    kernel keeps for the backward."""
    x32 = x.float()
    return torch.rsqrt((x32 * x32).mean(dim=-1) + eps)


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor | None,
                rstd: torch.Tensor, dy: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The backward kernel's formula in fp32: with x̂ = x·rstd,
    ``dx = rstd (γ dy - x̂ mean(γ dy x̂))`` (x's dtype) and
    ``dγ = Σ_rows dy x̂`` (fp32; None without gamma)."""
    x32, d = x.float(), dy.float()
    r = rstd.float()[:, None]
    xh = x32 * r
    gd = d * gamma.float() if gamma is not None else d
    dx = r * (gd - xh * (gd * xh).mean(dim=-1, keepdim=True))
    dgamma = (d * xh).sum(0) if gamma is not None else None
    return dx.to(x.dtype), dgamma


# ----------------------------------------------------------- attention

NEG_INF = -1e30     # the Pallas kernel's mask value (flash_attention.py:24)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, kv_len: int | None = None
                  ) -> torch.Tensor:
    """Grouped-query attention as ``_attn_kernel`` computes it.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0; only the
    first ``kv_len`` (default S) KV rows are read, as decode reads a
    cache.  Scale 1/sqrt(D), fp32 arithmetic, output in q's dtype.
    Query i sees key j when ``j <= i + (Skv - Sq)`` (causal) with
    ``Skv = kv_len``.  Where it differs from the jnp oracle
    ``repro.kernels.ref.mha_attention`` it follows the kernel: the causal
    mask applies at every ``Sq`` (at ``Sq = 1`` the offset makes it
    admit every key, so the two agree), masked scores are -1e30 and a
    row with no visible key gives 0 where the oracle gives NaN.
    """
    skv = k.shape[2] if kv_len is None else kv_len
    return _attend(q, k, v, causal, skv, skv - q.shape[2])


def mha_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_chunk: int = 1024
                          ) -> torch.Tensor:
    """``mha_attention`` over every KV row, ``q_chunk`` query rows at a
    time: the (Sq, Skv) scores never exist whole (the reference's
    ``mha_attention_chunked``, whose scan over query chunks this loop is;
    the long-prefill plain path).  Each chunk's rows take
    ``mha_attention``'s arithmetic over the keys they can see: causal,
    the keys before the chunk's last row's position and no others (the
    rest would add only zeros), so a causal prefill computes half the
    scores."""
    Sq, Skv = q.shape[2], k.shape[2]
    q_chunk = min(q_chunk, Sq)
    if Sq % q_chunk:
        raise ValueError(f"{Sq} query rows do not split into chunks of "
                         f"{q_chunk}")
    out = []
    for i in range(0, Sq, q_chunk):
        offset = i + Skv - Sq
        seen = max(0, min(Skv, offset + q_chunk)) if causal else Skv
        out.append(_attend(q[:, :, i:i + q_chunk], k, v, causal, seen,
                           offset))
    return torch.cat(out, dim=2)


def _attend(q, k, v, causal: bool, skv: int, offset: int) -> torch.Tensor:
    """``mha_attention`` over KV rows ``[0, skv)``, query row i at
    position ``i + offset``.  Where autograd records nothing, the passes
    over the scores run in place, the masks only over the key columns
    past ``offset`` (every row sees the earlier ones): the same numbers
    with one (Sq, skv) tensor live instead of three, and fewer passes (a
    32k prefill's score chunks are up to 12 GiB)."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    group = Hq // Hkv
    inplace = not (torch.is_grad_enabled()
                   and (q.requires_grad or k.requires_grad or v.requires_grad))
    qf = q.float() * (1.0 / math.sqrt(D))
    kf = k[:, :, :skv].float().repeat_interleave(group, dim=1)
    vf = v[:, :, :skv].float().repeat_interleave(group, dim=1)
    s = qf @ kf.transpose(-1, -2)                       # (B, Hq, Sq, Skv)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + offset
        ki = torch.arange(skv, device=q.device)[None, :]
        mask = ki <= qi
        seen = max(0, min(skv, offset + 1))
        s = _keep(s, mask, NEG_INF, seen, inplace)
    m = s.amax(dim=-1, keepdim=True) if skv else s.sum(-1, keepdim=True)
    p = s.sub_(m).exp_() if inplace else torch.exp(s - m)
    if causal:
        p = _keep(p, mask, 0.0, seen, inplace)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)


def _keep(t, mask, value: float, seen: int, inplace: bool) -> torch.Tensor:
    """``torch.where(mask, t, value)``; in place, over the columns from
    ``seen`` on (the mask holds every earlier one)."""
    if not inplace:
        return torch.where(mask, t, value)
    t[..., seen:].masked_fill_(~mask[:, seen:], value)
    return t


def _scores(q, k, causal):
    """fp32 scaled scores (B, Hq, Sq, Skv) over every KV row, k repeated
    over its query heads, and the visibility mask (None if not causal)."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    kf = k.float().repeat_interleave(Hq // k.shape[1], dim=1)
    s = (q.float() * (1.0 / math.sqrt(D))) @ kf.transpose(-1, -2)
    if not causal:
        return s, kf, None
    qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    return s, kf, torch.arange(Skv, device=q.device)[None, :] <= qi


def mha_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mha_attention`` over every KV row, and the fp32 natural
    log-sum-exp of each query row's scaled visible scores (B, Hq, Sq), -1e30
    for a row with no visible key: the prefill kernels' output under
    autograd."""
    s, _, mask = _scores(q, k, causal)
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, NEG_INF)
    return mha_attention(q, k, v, causal=causal), lse


def mha_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                      *, causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' formula (FlashAttention-2) in fp32:
    ``p = exp(s - lse)`` over the visible keys, ``delta = rowsum(dO·O)``,
    ``ds = p (dO Vᵀ - delta)``, ``dV = pᵀ dO``, ``dK = scale dsᵀ Q``,
    ``dQ = scale ds K``, each summed over the query heads of a KV head's
    group for dK and dV.  Returns (dq, dk, dv) in the operands' dtype."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    s, kf, mask = _scores(q, k, causal)
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    do = dout.float()
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (do @ vf.transpose(-1, -2) - delta)
    scale = 1.0 / math.sqrt(D)
    dq = scale * ds @ kf
    group = (B, Hkv, Hq // Hkv)
    dk = (scale * ds.transpose(-1, -2) @ q.float()).view(*group, -1, D).sum(2)
    dv = (p.transpose(-1, -2) @ do).view(*group, -1, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- mamba2 ssd

def _ssd_heads(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """b, c (..., G, N) as fp32 per head (..., H, N): head h reads group
    ``h // (H / G)``, as ``jnp.repeat`` along the group axis gives."""
    H, G = x.shape[-2], b.shape[-2]
    if H % G:
        raise ValueError(f"{H} heads do not group over {G} state groups")
    rep = H // G
    return (b.float().repeat_interleave(rep, dim=-2),
            c.float().repeat_interleave(rep, dim=-2))


def _ssd_state0(x: torch.Tensor, N: int,
                initial_state: torch.Tensor | None) -> torch.Tensor:
    B, _, H, P = x.shape
    if initial_state is None:
        return torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    return initial_state.float()


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, initial_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 state-space duality by the plain recurrence.

    x: (B, S, H, P) per-head inputs; a: (B, S, H) log-decay (a <= 0);
    b, c: (B, S, G, N) with H % G == 0; initial_state (B, H, P, N).
    ``state[t] = exp(a[t]) state[t-1] + x[t] b[t]ᵀ``, ``y[t] = state[t]
    c[t]``.  fp32 arithmetic; returns (y in x's dtype, the fp32 state
    after the last position).
    """
    bf, cf = _ssd_heads(x, b, c)
    xf, af = x.float(), a.float()
    state = _ssd_state0(x, b.shape[-1], initial_state)
    ys = []
    for t in range(x.shape[1]):
        state = (torch.exp(af[:, t])[:, :, None, None] * state
                 + xf[:, t, :, :, None] * bf[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.clone()
    return y.to(x.dtype), state


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, *, chunk: int = 64,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD algorithm of the kernel, with the contract of
    ``ssd_scan`` (S a multiple of ``chunk``): per chunk the
    attention-like intra-chunk term ``((C Bᵀ) ∘ L) X`` with ``L[t, s] =
    exp(acs[t] - acs[s])`` for s <= t, plus the inter-chunk term
    ``exp(acs[t]) · C S_prevᵀ``; the chunk states chain by a recurrence
    over the chunks."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S {S} is not a multiple of chunk "
                         f"{chunk}")
    nc = S // chunk
    bh, ch = _ssd_heads(x, b, c)
    xf = x.float().reshape(B, nc, chunk, H, P)
    af = a.float().reshape(B, nc, chunk, H)
    bf = bh.reshape(B, nc, chunk, H, N)
    cf = ch.reshape(B, nc, chunk, H, N)

    acs = torch.cumsum(af, dim=2)                          # (B,nc,L,H)
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]    # (B,nc,L,L,H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    # exp of the pairs s <= t only: above the diagonal seg overflows, and
    # autograd through a where over an inf gives NaN (0 * inf)
    L = torch.exp(torch.where(tri[None, None, :, :, None], seg, -math.inf))

    cb = torch.einsum("bnthi,bnshi->bnhts", cf, bf)        # (B,nc,H,L,L)
    y_diag = torch.einsum("bnhts,bnshp->bnthp", cb * L.movedim(-1, 2), xf)

    decay_out = torch.exp(acs[:, :, -1:, :] - acs)         # (B,nc,L,H)
    states = torch.einsum("bnsh,bnshi,bnshp->bnhpi", decay_out, bf, xf)
    chunk_decay = torch.exp(acs[:, :, -1, :])              # (B,nc,H)
    state = _ssd_state0(x, N, initial_state)
    prevs = []
    for n in range(nc):
        prevs.append(state)        # the state entering chunk n
        state = chunk_decay[:, n, :, None, None] * state + states[:, n]
    prev = torch.stack(prevs, dim=1)                       # (B,nc,H,P,N)

    y_off = torch.einsum("bnthi,bnhpi,bnth->bnthp", cf, prev, torch.exp(acs))
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), state


def ssd_chained(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, *, segment: int, chunk: int = 128,
                initial_state: torch.Tensor | None = None):
    """``ssd_chunked`` over consecutive ``segment``-position slices of the
    sequence, each from the state the slice before it left: yields
    (start, y of the slice, the fp32 state after it).  Chunks never cross
    a slice (``segment`` is a multiple of ``chunk``), so this is one
    call's recurrence at one slice's memory: the plain version at lengths
    whose heads-wide b, c and chunk scores would not fit at once."""
    S = x.shape[1]
    if segment % chunk or S % segment:
        raise ValueError(f"ssd_chained: segments of {segment} must hold "
                         f"whole chunks of {chunk} and divide S {S}")
    state = initial_state
    for s in range(0, S, segment):
        sl = slice(s, s + segment)
        y, state = ssd_chunked(x[:, sl], a[:, sl], b[:, sl], c[:, sl],
                               chunk=chunk, initial_state=state)
        yield s, y, state


# ``ssd_plain`` runs the chunked algorithm over consecutive segments of
# this many positions where they divide a longer sequence, so that its
# heads-wide fp32 b and c and its (L, L) chunk terms, which grow with S x
# heads, take one segment's memory
SSD_PLAIN_SEGMENT = 8192


def ssd_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, *, chunk: int = 128,
              initial_state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain side of ``ops.ssd``, chosen as the reference chooses
    (``src/repro/kernels/ops.py:127-131``): the chunked algorithm when S
    is a multiple of ``chunk`` and longer than it, else the recurrence.
    One departure, for memory alone: past SSD_PLAIN_SEGMENT positions
    that it divides, the chunked algorithm runs over segments chained
    through the state (``ssd_chained``: the same recurrence, computed a
    segment at a time, where the reference makes one call)."""
    S = x.shape[1]
    if S % chunk == 0 and S > chunk:
        seg = SSD_PLAIN_SEGMENT
        if S > seg and S % seg == 0 and seg % chunk == 0:
            parts = list(ssd_chained(x, a, b, c, segment=seg, chunk=chunk,
                                     initial_state=initial_state))
            return torch.cat([y for _, y, _ in parts], 1), parts[-1][2]
        return ssd_chunked(x, a, b, c, chunk=chunk,
                           initial_state=initial_state)
    return ssd_scan(x, a, b, c, initial_state=initial_state)


def ssd_bwd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, dy: torch.Tensor, *, chunk: int = 128,
            initial_state: torch.Tensor | None = None,
            dfinal: torch.Tensor | None = None):
    """The backward of the chunked SSD as the ``ssd_bwd`` kernels compute
    it, in fp32: ``(dx, da, db, dc, d initial_state)`` for the upstream
    gradients ``dy`` of y and ``dfinal`` of the final state (None: zero).

    Chunks of ``min(chunk, S)`` positions, the last one zero-padded where
    they do not divide S (a = x = b = c = dy = 0 there, so nothing past S
    contributes).  Per chunk, with ``acs`` the in-chunk cumsum of a,
    ``L[t, s] = exp(acs[t] - acs[s])`` (s <= t), S_prev the state entering
    the chunk and G the gradient of the state leaving it:

      G_prev = exp(acs[-1]) G + Σ_t exp(acs[t]) dy[t]ᵀ C[t]   (reverse
               recurrence over the chunks; the first chunk's G_prev is the
               initial state's gradient)
      R = (C Bᵀ) ∘ L,  Z = (dY Xᵀ) ∘ L,  w[s] = exp(acs[-1] - acs[s])
      dx = Rᵀ dY + w ∘ (B Gᵀ)
      dC = Z B + exp(acs) ∘ (dY S_prev)
      dB = Zᵀ C + w ∘ (X G)
      dacs[t] = Σ_s Q[t, s] - Σ_s Q[s, t] + Yoff[t] - W[t],  Q = R ∘ (dY Xᵀ),
               Yoff[t] = Σ_n C[t] dC_inter[t], W[s] = Σ_p X[s] dx_state[s]
      da = reverse cumsum of dacs + exp(acs[-1]) <G, S_prev> + Σ_s W[s]

    db and dc sum the heads of each state group.  Returns dx in x's dtype,
    da fp32, db and dc in b's dtype, and the fp32 initial state's
    gradient where an initial state was given (else None)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    L = min(chunk, max(S, 1))
    nc = -(-S // L)
    pad = nc * L - S
    bh, ch = _ssd_heads(x, b, c)

    def chunks(t, *tail):                     # zero-pad S, split chunks
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((B, pad, *t.shape[2:]))], dim=1)
        return t.reshape(B, nc, L, *tail)

    xf, dyf = chunks(x, H, P), chunks(dy, H, P)
    af = chunks(a, H)
    bf, cf = chunks(bh, H, N), chunks(ch, H, N)

    acs = torch.cumsum(af, dim=2)                          # (B,nc,L,H)
    last = acs[:, :, -1, :]                                # (B,nc,H)
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]    # (B,nc,t,s,H)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                               -math.inf)).movedim(-1, 2)  # (B,nc,H,t,s)
    w = torch.exp(last[:, :, None, :] - acs)               # (B,nc,L,H)
    e = torch.exp(acs)

    # the states entering each chunk (the forward's), then the gradients
    # of the states leaving each chunk, in reverse
    states = torch.einsum("bnsh,bnshi,bnshp->bnhpi", w, bf, xf)
    state = _ssd_state0(x, N, initial_state)
    prevs = []
    for n in range(nc):
        prevs.append(state)
        state = torch.exp(last[:, n])[:, :, None, None] * state + states[:, n]
    prev = torch.stack(prevs, dim=1)                       # (B,nc,H,P,N)
    g = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if dfinal is None else dfinal.float())
    inflow = torch.einsum("bnth,bnthp,bnthi->bnhpi", e, dyf, cf)
    grads = [None] * nc
    for n in reversed(range(nc)):
        grads[n] = g               # the gradient of the state leaving n
        g = torch.exp(last[:, n])[:, :, None, None] * g + inflow[:, n]
    gs = torch.stack(grads, dim=1)                         # (B,nc,H,P,N)

    cb = torch.einsum("bnthi,bnshi->bnhts", cf, bf)
    dyx = torch.einsum("bnthp,bnshp->bnhts", dyf, xf)
    R, Z = cb * Lm, dyx * Lm
    Q = R * dyx
    dx_state = w[..., None] * torch.einsum("bnshi,bnhpi->bnshp", bf, gs)
    dx = torch.einsum("bnhts,bnthp->bnshp", R, dyf) + dx_state
    dc_inter = e[..., None] * torch.einsum("bnthp,bnhpi->bnthi", dyf, prev)
    dc = torch.einsum("bnhts,bnshi->bnthi", Z, bf) + dc_inter
    db = torch.einsum("bnhts,bnthi->bnshi", Z, cf) \
        + w[..., None] * torch.einsum("bnshp,bnhpi->bnshi", xf, gs)
    W = (xf * dx_state).sum(-1)                            # (B,nc,L,H)
    dacs = (Q.sum(-1) - Q.sum(-2)).movedim(2, -1) \
        + (cf * dc_inter).sum(-1) - W
    total = torch.exp(last) * (gs * prev).sum((-1, -2)) + W.sum(2)
    da = torch.flip(torch.cumsum(torch.flip(dacs, [2]), 2), [2]) \
        + total[:, :, None, :]

    def unchunk(t):
        return t.reshape(B, nc * L, *t.shape[3:])[:, :S]

    rep = H // G
    db = unchunk(db).reshape(B, S, G, rep, N).sum(3)
    dc = unchunk(dc).reshape(B, S, G, rep, N).sum(3)
    return (unchunk(dx).to(x.dtype), unchunk(da), db.to(b.dtype),
            dc.to(c.dtype), None if initial_state is None else g)


def ssd_decode_step(x_t: torch.Tensor, a_t: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of SSD: x_t (B, H, P), a_t (B, H), b_t / c_t (B, G, N),
    state (B, H, P, N) fp32.  Returns (y (B, H, P) in x_t's dtype, the
    new fp32 state)."""
    bf, cf = _ssd_heads(x_t, b_t, c_t)
    decay = torch.exp(a_t.float())[:, :, None, None]
    state = decay * state + x_t.float()[..., None] * bf[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, cf)
    return y.to(x_t.dtype), state
