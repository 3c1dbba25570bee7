"""Model building blocks: norms, RoPE and M-RoPE, GQA self- and
cross-attention, the dense MLP and the MoE FFN.

Port of ``repro.models.layers``.  Parameters are plain
dicts of tensors with the reference's names and layouts: a weight is
``(in, out)`` and applied as ``x @ w``, cast to the activations' dtype
at use (``w.to(x.dtype)``, a no-op once ``lm.cast_params`` has cast it
at load).  Norm gains stay fp32, as in the reference.  The norms and
attention run on the port's kernels through ``kernels.ops``; ``plain``
selects their plain versions.  The matrix products stay ``torch.matmul``
as the reference leaves them to XLA, and so do the MoE's expert
products (``torch.bmm``).  Each ``*_specs`` function gives the logical
axes of its parameters (the reference's specs, consumed by
``parallel.sharding``); the ``constrain`` calls sit where the reference's
do and act only under ``sharding.use_rules``.  There the activations and
parameters are DTensors: the kernels see this rank's tensors through
``kernels.ops``, and the MoE FFN runs its routing and dispatch on each
rank's rows and experts (``_moe_sharded``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from ..parallel.sharding import (block_index, constrain, from_block,
                                 merge_last, place, split_last, write_rows)


def _init(gen: torch.Generator, shape: tuple[int, ...], device: torch.device,
          scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


# ------------------------------------------------------------------- norms

def init_norm(cfg, device: torch.device, d: int | None = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def norm_specs(cfg) -> dict:
    if cfg.norm_kind == "layernorm":
        return {"scale": ("embed_act",), "bias": ("embed_act",)}
    return {"scale": ("embed_act",)}


def apply_norm(cfg, p: dict, x: torch.Tensor, *, plain: bool = False
               ) -> torch.Tensor:
    if cfg.norm_kind == "layernorm":
        # rows in x's own dtype (bf16 when served): the kernel, like the
        # reference's layernorm_rows, computes in fp32 and rounds to x's
        # dtype once, at its store, so no cast runs before or after it
        return ops.layernorm(x, p["scale"], p["bias"], plain=plain)
    return ops.rmsnorm(x, p["scale"], plain=plain)


# -------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=32)
def _device_freqs(head_dim: int, theta: float, device: torch.device
                  ) -> torch.Tensor:
    """``rope_freqs`` as fp32 on ``device``, copied there once: a copy from
    host memory at every call would hold the host until the card caught
    up."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               m_rope_sections: tuple[int, ...] | None = None
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S), or (3, B, S) for M-RoPE.
    Rotates the two halves of the head in fp32 (frequencies from numpy
    float64, cast to fp32) and casts back to x's dtype.

    M-RoPE (qwen2-vl): the D/2 frequencies are split into temporal,
    height and width sections, each rotated by its own position stream;
    for text the three streams are equal and it reduces to RoPE."""
    D = x.shape[-1]
    freqs = _device_freqs(D, theta, x.device)
    if positions.dim() == 2:
        ang = positions.float()[:, :, None] * freqs[None, None]  # (B,S,D/2)
    else:
        if m_rope_sections is None or sum(m_rope_sections) != D // 2:
            raise ValueError(f"M-RoPE sections {m_rope_sections} must sum "
                             f"to head_dim / 2 = {D // 2}")
        parts, start = [], 0
        for si, sec in enumerate(m_rope_sections):
            f = freqs[start:start + sec]
            parts.append(positions[si].float()[:, :, None] * f[None, None])
            start += sec
        ang = torch.cat(parts, dim=-1)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., : D // 2], x32[..., D // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention

def init_attention(cfg, gen: torch.Generator, device: torch.device) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": _init(gen, (d, qd), device),
        "wk": _init(gen, (d, kvd), device),
        "wv": _init(gen, (d, kvd), device),
        "wo": _init(gen, (qd, d), device, scale=1.0 / math.sqrt(qd)),
    }
    if cfg.qkv_bias:
        p |= {"bq": torch.zeros(qd, device=device),
              "bk": torch.zeros(kvd, device=device),
              "bv": torch.zeros(kvd, device=device)}
    if cfg.qk_norm:
        p |= {"q_norm": torch.ones(cfg.head_dim, device=device),
              "k_norm": torch.ones(cfg.head_dim, device=device)}
    return p


def attention_specs(cfg) -> dict:
    s = {"wq": ("embed", "q_dim"), "wk": ("embed", "kv_dim"),
         "wv": ("embed", "kv_dim"), "wo": ("q_dim", "embed")}
    if cfg.qkv_bias:
        s |= {"bq": ("q_dim",), "bk": ("kv_dim",), "bv": ("kv_dim",)}
    if cfg.qk_norm:
        s |= {"q_norm": ("head_dim",), "k_norm": ("head_dim",)}
    return s


def _project_q(cfg, p: dict, x: torch.Tensor, *, plain: bool = False
               ) -> torch.Tensor:
    """q as (B, S, Hq, D), with its bias and q-norm where the arch has
    them, before any rotation."""
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = split_last(q, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p["q_norm"], plain=plain)
    return q


def _project_kv(cfg, p: dict, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """k and v as (B, S, Hkv, D), with their biases where the arch has
    them."""
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (split_last(k, cfg.n_kv_heads, cfg.head_dim),
            split_last(v, cfg.n_kv_heads, cfg.head_dim))


def _project_qkv(cfg, p: dict, x: torch.Tensor,
                 positions: torch.Tensor | None, *, rope: bool = True,
                 plain: bool = False):
    """q, k, v, the k-norm where the arch has it, and RoPE (M-RoPE for
    ``cfg.m_rope``) where ``rope`` and ``positions`` are given: the
    sinusoidal archs pass none."""
    q = _project_q(cfg, p, x, plain=plain)
    k, v = _project_kv(cfg, p, x)
    if cfg.qk_norm:
        k = ops.rmsnorm(k, p["k_norm"], plain=plain)
    if rope and positions is not None:
        sections = cfg.m_rope_sections if cfg.m_rope else None
        q = apply_rope(q, positions, cfg.rope_theta, sections)
        k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def attention_fwd(cfg, p: dict, x: torch.Tensor,
                  positions: torch.Tensor | None, *, causal: bool = True,
                  kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                  plain: bool = False):
    """Full-sequence attention (prefill, or an encoder with
    ``causal=False``).  ``kv_override``: (k, v) of an encoder in the
    (B, Hkv, Senc, D) layout, for cross-attention: q takes no rotation.
    Returns (out, (k, v)) with k/v in the cache's (B, Hkv, S, D) layout."""
    S = x.shape[1]
    if kv_override is None:
        q, k, v = _project_qkv(cfg, p, x, positions, plain=plain)
        k_t = k.transpose(1, 2).contiguous()
        v_t = v.transpose(1, 2).contiguous()
    else:
        q = _project_q(cfg, p, x, plain=plain)
        k_t, v_t = kv_override
    q_t = constrain(q.transpose(1, 2).contiguous(),
                    "batch_attn", "heads", None, None)
    # the plain path is chunked over queries at and past the threshold, as
    # the reference's (the dense (Sq, Skv) scores never exist)
    out = ops.attention(q_t, k_t, v_t, causal=causal, plain=plain,
                        chunked=S >= cfg.attn_chunk_threshold)
    out = merge_last(out.transpose(1, 2)) @ p["wo"].to(x.dtype)
    return constrain(out, "batch", None, "embed_act"), (k_t, v_t)


def encode_kv(cfg, p: dict, enc_out: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention k/v from the encoder's output: (B, Hkv, Senc, D)
    each, contiguous."""
    k, v = _project_kv(cfg, p, enc_out)
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())


def attention_decode(cfg, p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, *, cross: bool = False,
                     kv_len: int | None = None, rope: bool = True,
                     plain: bool = False):
    """Single-token attention.  x: (B, 1, D); cache_k/v:
    (B, Hkv, Smax, D); pos: tokens already in the cache.

    Self-attention writes this token's k/v into row ``pos`` of the caches
    in place (the reference's ``dynamic_update_slice`` returns new
    arrays; ``cfg.kv_cache_repeat`` copies of each KV head, as the cache
    holds them) and attends over rows ``[0, pos]``; ``rope=False`` leaves q
    and k unrotated (the sinusoidal archs).  Cross-attention
    (``cross=True``) reads the encoder's k/v from the caches, writes
    nothing and attends over their first ``kv_len`` rows (default all).
    Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    if not cross:
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        if cfg.m_rope:
            positions = positions[None].expand(3, B, 1)
        q, k, v = _project_qkv(cfg, p, x, positions, rope=rope, plain=plain)
        k, v = (repeat_kv(cfg, t.transpose(1, 2)) for t in (k, v))
        write_rows(cache_k, k, pos)
        write_rows(cache_v, v, pos)
        valid = pos + 1
    else:
        q = _project_q(cfg, p, x, plain=plain)
        valid = cache_k.shape[2] if kv_len is None else kv_len
    q_t = q.transpose(1, 2).contiguous()
    out = ops.attention(q_t, cache_k.to(q_t.dtype), cache_v.to(q_t.dtype),
                        causal=False, kv_len=valid, plain=plain)
    return merge_last(out.transpose(1, 2)) @ p["wo"].to(x.dtype), cache_k, \
        cache_v


# ---------------------------------------------------------------- dense mlp

def init_mlp(cfg, gen: torch.Generator, device: torch.device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": _init(gen, (d, f), device),
                "w_up": _init(gen, (d, f), device),
                "w_down": _init(gen, (f, d), device, scale=1.0 / math.sqrt(f))}
    return {"w_up": _init(gen, (d, f), device),
            "w_down": _init(gen, (f, d), device, scale=1.0 / math.sqrt(f))}


def repeat_kv(cfg, t: torch.Tensor) -> torch.Tensor:
    """k or v (B, Hkv, S, D) with each head repeated
    ``cfg.kv_cache_repeat`` times in place, as the cache holds them (the
    reference's ``jnp.repeat`` over the heads)."""
    r = cfg.kv_cache_repeat
    return t if r == 1 else t.repeat_interleave(r, dim=1)


def mlp_specs(cfg) -> dict:
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
    return {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def mlp_fwd(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    elif cfg.mlp_kind == "relu2":
        h = torch.square(torch.clamp_min(x @ p["w_up"].to(x.dtype), 0.0))
    else:  # gelu, the tanh form (jax.nn.gelu's default)
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    h = constrain(h, "batch", None, "mlp")
    return constrain(h @ p["w_down"].to(x.dtype), "batch", None, "embed_act")


# ---------------------------------------------------------------------- moe

def init_moe(cfg, gen: torch.Generator, device: torch.device,
             dtype: torch.dtype | None = None, rules=None) -> dict:
    """The reference's MoE leaves: ``router`` (d, E), kept fp32, and the
    experts' ``w_gate`` / ``w_up`` (E, d, f) and ``w_down`` (E, f, d)
    (no ``w_gate`` unless swiglu), at the reference's scales: its default
    1/sqrt(shape[0]) is 1/sqrt(E) for the (E, d, f) leaves; ``w_down``
    takes 1/sqrt(f).

    Each expert leaf is allocated in ``dtype`` (None: fp32) and filled
    one expert at a time from an fp32 (d, f) or (f, d) draw, cast as it is
    copied in: at most one fp32 expert matrix is live beside the leaves
    (one fp32 MoE layer of llama4-maverick is 60 GiB).  With ``rules``
    (``sharding.make_rules``) the leaves come placed on their mesh by
    ``moe_specs``: a rank allocates its block alone and copies in its part
    of each expert it holds, after every expert is drawn in turn."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = moe_specs(cfg)
    p = {"router": _init(gen, (d, E), device, scale=0.02)}
    if rules is not None:
        p["router"] = place(p["router"],
                            rules.sharding_for(specs["router"], (d, E)))
    leaves = {"w_gate": ((d, f), 1.0 / math.sqrt(E)),
              "w_up": ((d, f), 1.0 / math.sqrt(E)),
              "w_down": ((f, d), 1.0 / math.sqrt(f))}
    if cfg.mlp_kind != "swiglu":
        del leaves["w_gate"]
    for name, (shape, scale) in leaves.items():
        full = (E, *shape)
        sh = None if rules is None else rules.sharding_for(specs[name], full)
        block = (tuple(slice(0, n) for n in full) if sh is None
                 else block_index(full, sh.mesh, sh.placements))
        leaf = torch.empty(tuple(b.stop - b.start for b in block),
                           dtype=dtype or torch.float32, device=device)
        for e in range(E):
            draw = _init(gen, shape, device, scale)
            if block[0].start <= e < block[0].stop:
                leaf[e - block[0].start].copy_(draw[block[1:]])
            del draw       # before the next expert is drawn
        p[name] = leaf if sh is None else from_block(leaf, sh, full)
    return p


def moe_specs(cfg) -> dict:
    s = {"router": ("embed", "experts"),
         "w_up": ("experts", "embed", "mlp"),
         "w_down": ("experts", "mlp", "embed")}
    if cfg.mlp_kind == "swiglu":
        s["w_gate"] = ("experts", "embed", "mlp")
    return s


class MoeRoute(NamedTuple):
    """One MoE call's routing, shared by both dispatch paths.  ``xg``:
    the tokens in groups (G, Sg, D); ``probs``: the router's fp32 softmax
    (G, Sg, E); ``gate``: the top-k probabilities, renormalised, and
    ``idx``: their experts (G, Sg, K), the largest first; ``pos``: each
    choice's place in its expert's queue (G, Sg, K), kept where it is
    under ``cap``, the slots an expert has in a group."""
    xg: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    cap: int


def moe_route(cfg, p: dict, x: torch.Tensor, group_size: int = 1024
              ) -> MoeRoute:
    """Route x (B, S, D) in groups of ``min(group_size, S)`` tokens: the
    router on fp32 (``x.float() @ router``; PyTorch's fp32 products run
    on fp32 FMA unless ``allow_tf32`` is set), softmax, top-k (a stable
    sort: equal probabilities keep the lower expert first, as
    ``jax.lax.top_k``), the gates renormalised, and the queue positions
    in GShard's order: slot-major, then token order, so that every
    token's first choice queues before any token's second (a cumsum over
    the (K·Sg, E) flattening)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    Sg = min(group_size, S)
    if S % Sg:
        raise ValueError(f"{S} tokens do not split into groups of {Sg}")
    G = B * (S // Sg)
    xg = x.reshape(G, Sg, D)
    probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[..., :K], order[..., :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # counted along the innermost dim of (G, E, K·Sg): CUDA scans an outer
    # dim one thread a column, 0.41 ms a call at dbrx's prefill on the H100
    oh = F.one_hot(idx.transpose(1, 2).reshape(G, K * Sg), E)
    oh = oh.transpose(1, 2).contiguous()
    pos = ((oh.cumsum(-1) - oh) * oh).sum(1)
    cap = max(1, int(math.ceil(Sg * K / E * cfg.capacity_factor)))
    return MoeRoute(xg, probs, gate, idx,
                    pos.view(G, K, Sg).transpose(1, 2), cap)


def _experts(cfg, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on its capacity slots: xe (E, N, d) -> (E, N, d)
    (SiLU gate for swiglu, the tanh GELU otherwise, as the reference)."""
    cd = xe.dtype
    if cfg.mlp_kind == "swiglu":
        h = F.silu(torch.bmm(xe, p["w_gate"].to(cd))) \
            * torch.bmm(xe, p["w_up"].to(cd))
    else:
        h = F.gelu(torch.bmm(xe, p["w_up"].to(cd)), approximate="tanh")
    return torch.bmm(h, p["w_down"].to(cd))


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in fp32: an all-zero row where ``i`` is outside
    [0, n), as for a choice past the capacity (``F.one_hot`` raises)."""
    return (i[..., None] == torch.arange(n, device=i.device)).float()


def _moe_onehot(cfg, p: dict, r: MoeRoute, e0: int = 0):
    """The plain version: the reference's GShard einsums over one-hot
    (G, Sg, E, C) dispatch and combine tensors, with the queue positions
    taken again from an fp32 cumsum.  Returns (y (G, Sg, D), the share of
    tokens each expert kept (E,), the dispatched slots xe (E, G·C, D)).
    The experts of ``p`` are ``e0 ..`` (all of them by default): y then
    sums theirs alone."""
    G, Sg, D = r.xg.shape
    E, K, cap, cd = cfg.n_experts, cfg.top_k, r.cap, r.xg.dtype
    El = p["w_up"].shape[0]
    onehot = _one_hot(r.idx, E)                               # (G, Sg, K, E)
    oh_flat = onehot.transpose(1, 2).reshape(G, K * Sg, E)
    pos = torch.cumsum(oh_flat, 1) - oh_flat
    keep = (pos < cap) * oh_flat
    pos_idx = torch.einsum("gte,gte->gt", pos, oh_flat).int()
    disp_flat = keep[..., None] * _one_hot(pos_idx, cap)[:, :, None, :]
    dispatch = disp_flat.view(G, K, Sg, E, cap).sum(1)        # (G, Sg, E, C)
    combine = torch.einsum("gsec,gsk,gske->gsec", dispatch, r.gate, onehot)
    mine = dispatch[:, :, e0:e0 + El]
    xe = torch.einsum("gsec,gsd->egcd", mine.to(cd), r.xg)
    xe = xe.reshape(El, G * cap, D)
    ye = _experts(cfg, p, xe).view(El, G, cap, D)
    y = torch.einsum("gsec,egcd->gsd", combine[:, :, e0:e0 + El].to(cd), ye)
    return y, dispatch.sum(-1).mean((0, 1)), xe


def _moe_index(cfg, p: dict, r: MoeRoute, e0: int = 0):
    """The main path: the same slots filled by index.  Each kept choice
    of an expert of ``p`` (``e0 ..``, all by default) goes to slot
    (expert, group, pos) of a flat (E·G·C) layout, any other choice (past
    the capacity, or another rank's expert) to a spare slot past its end
    that no expert reads;
    each slot gathers its token's row (empty slots a zero row), bit for
    bit the one-hot einsum's xe.  The combine gathers each choice's
    expert output back, with its gate cast to the compute dtype first
    (the reference's ``combine.astype(cd)``), sums the K products in fp32
    and rounds once, as the reference's bf16 einsum does.  No host sync.
    Returns what ``_moe_onehot`` returns."""
    G, Sg, D = r.xg.shape
    E, K, cap, cd = cfg.n_experts, cfg.top_k, r.cap, r.xg.dtype
    El = p["w_up"].shape[0]
    dev = r.xg.device
    keep = r.pos < cap
    mine = keep if El == E else keep & (r.idx >= e0) & (r.idx < e0 + El)
    spare = El * G * cap
    group = torch.arange(G, device=dev)[:, None, None]
    slot = torch.where(mine, ((r.idx - e0) * G + group) * cap + r.pos, spare)
    token = torch.arange(G * Sg, device=dev).view(G, Sg, 1).expand(G, Sg, K)
    # the token in each slot; G·Sg names the zero row (the spare slot,
    # written by every dropped choice, is cut off)
    filled = torch.full((spare + 1,), G * Sg, dtype=torch.long, device=dev)
    filled.scatter_(0, slot.reshape(-1), token.reshape(-1))
    rows = torch.cat([r.xg.reshape(G * Sg, D), r.xg.new_zeros(1, D)])
    xe = rows[filled[:spare]].view(El, G * cap, D)
    ye = _experts(cfg, p, xe)
    out = torch.cat([ye.reshape(spare, D), ye.new_zeros(1, D)])[slot]
    w = torch.where(mine, r.gate, 0.0).to(cd).float()
    y = out[:, :, 0].float() * w[..., :1]
    for k in range(1, K):
        y = y + out[:, :, k].float() * w[..., k:k + 1]
    kept = torch.zeros(E, device=dev).index_add_(0, r.idx.reshape(-1),
                                                  keep.reshape(-1).float())
    return y.to(cd), kept / (G * Sg), xe


def moe_fwd(cfg, p: dict, x: torch.Tensor, group_size: int = 1024, *,
            plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded top-k MoE FFN with deterministic in-group
    dispatch (``moe_route``): x (B, S, D) -> (y, aux).  Each expert takes
    at most ``cap`` tokens of a group; a choice past that is dropped (it
    adds nothing to its token's output).  The experts run on their
    (E, G·C, D) slots as three batched products.  ``plain`` runs the
    reference's one-hot einsum form, else the slots are filled and read
    back by index (``_moe_index``).  ``aux`` is the Switch load-balance
    loss, E · Σ(share of tokens kept · mean router probability) ·
    ``router_aux_weight``."""
    if isinstance(x, DTensor):
        y, density, router_mean = _moe_sharded(cfg, p, x, group_size, plain)
    else:
        y, density, router_mean = _moe_local(cfg, p, x, group_size, plain)
    aux = cfg.n_experts * (density * router_mean).sum() \
        * cfg.router_aux_weight
    return constrain(y, "batch", None, "embed_act"), aux


def _moe_local(cfg, p: dict, x: torch.Tensor, group_size: int, plain: bool,
               e0: int = 0):
    """(y, each expert's kept share, the mean router probability) of the
    tokens ``x`` (B, S, D), y summing the experts of ``p`` (``e0 ..``)."""
    r = moe_route(cfg, p, x, group_size)
    y, density, _ = (_moe_onehot if plain else _moe_index)(cfg, p, r, e0)
    return y.reshape(x.shape), density, r.probs.mean((0, 1))


def _moe_sharded(cfg, p: dict, x: DTensor, group_size: int, plain: bool):
    """The MoE FFN on DTensors, in two regions run on each rank's tensors.
    The rows keep their batch shards (a route group is ``min(group_size,
    S)`` tokens of one row, so no group is split and the drops are the
    meshless run's).  The route runs on each rank's rows with the whole
    router (its gradient a partial sum over the row shards); the experts
    keep their shards (``"experts" -> model``), each rank filling and
    running its own experts' slots, so y and the gradients of x and the
    gates are partial sums over the expert shards.  The kept counts are
    summed over the row shards before the aux loss."""
    mesh = x.device_mesh
    names = sorted(k for k in p if k != "router")
    rows = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in x.placements]
    rep = [Replicate()] * mesh.ndim
    by_rows = [Partial() if isinstance(pl, Shard) else Replicate()
               for pl in rows]
    w = p["w_up"]
    e_dims = [md for md, pl in enumerate(w.placements)
              if isinstance(pl, Shard) and pl.dim == 0] \
        if isinstance(w, DTensor) else []
    coord = mesh.get_coordinate()
    n_shards, idx = 1, 0
    for md in e_dims:
        n_shards *= mesh.size(md)
        idx = idx * mesh.size(md) + coord[md]
    e0 = idx * (cfg.n_experts // n_shards)
    B, S, D = x.shape
    Sg = min(group_size, S)
    cap = max(1, int(math.ceil(Sg * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor)))

    def route(xl, router):
        r = moe_route(cfg, {"router": router}, xl, group_size)
        kept = torch.zeros(cfg.n_experts, device=xl.device).index_add_(
            0, r.idx.reshape(-1), (r.pos < r.cap).reshape(-1).float())
        return r.probs, r.gate, r.idx, r.pos, kept

    probs, gate, ids, pos, kept = local_map(
        route, out_placements=(rows, rows, rows, rows, by_rows),
        in_placements=(rows, rep), in_grad_placements=(rows, by_rows),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])

    def experts(xl, gl, il, pl_, *ws):
        r = MoeRoute(xl.reshape(-1, Sg, D), None, gl, il, pl_, cap)
        y, _, _ = (_moe_onehot if plain else _moe_index)(
            cfg, dict(zip(names, ws)), r, e0)
        return y.reshape(xl.shape)

    split = [Partial() if md in e_dims else pl for md, pl in enumerate(rows)]
    w_pl = [Shard(0) if md in e_dims else Replicate()
            for md in range(mesh.ndim)]
    w_grad = [Partial() if isinstance(pl, Shard) else w_
              for pl, w_ in zip(rows, w_pl)]
    y = local_map(
        experts, out_placements=split,
        in_placements=(rows, rows, rows, rows, *[w_pl] * len(names)),
        in_grad_placements=(split, split, rows, rows,
                            *[w_grad] * len(names)),
        device_mesh=mesh, redistribute_inputs=True)(
        x, gate, ids, pos, *(p[k] for k in names))
    return y, kept / (B * S), probs.mean((0, 1))
