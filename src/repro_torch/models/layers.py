"""Model building blocks: norms, RoPE and M-RoPE, GQA self- and
cross-attention and the dense MLP.

Port of the dense parts of ``repro.models.layers``.  Parameters are plain
dicts of tensors with the reference's names and layouts: a weight is
``(in, out)`` and applied as ``x @ w``, cast to the activations' dtype
at use (``w.to(x.dtype)``, a no-op once ``lm.cast_params`` has cast it
at load).  Norm gains stay fp32, as in the reference.  The norms and
attention run on the port's kernels through ``kernels.ops``; ``plain``
selects their plain versions.  The matrix products stay ``torch.matmul``
as the reference leaves them to XLA.  Sharding specs wait for the
multi-device layer (ROADMAP A.6); MoE (``init_moe`` / ``moe_fwd``)
waits for A.4.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops


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


def _project_q(cfg, p: dict, x: torch.Tensor, *, plain: bool = False
               ) -> torch.Tensor:
    """q as (B, S, Hq, D), with its bias and q-norm where the arch has
    them, before any rotation."""
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p["q_norm"], plain=plain)
    return q


def _project_kv(cfg, p: dict, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """k and v as (B, S, Hkv, D), with their biases where the arch has
    them."""
    B, S, _ = x.shape
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


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
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = _project_qkv(cfg, p, x, positions, plain=plain)
        k_t = k.transpose(1, 2).contiguous()
        v_t = v.transpose(1, 2).contiguous()
    else:
        q = _project_q(cfg, p, x, plain=plain)
        k_t, v_t = kv_override
    q_t = q.transpose(1, 2).contiguous()
    out = ops.attention(q_t, k_t, v_t, causal=causal, plain=plain)
    out = out.transpose(1, 2).reshape(B, S, cfg.q_dim)
    return out @ p["wo"].to(x.dtype), (k_t, v_t)


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
    arrays) and attends over rows ``[0, pos]``; ``rope=False`` leaves q
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
        cache_k[:, :, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, :, pos] = v[:, 0].to(cache_v.dtype)
        valid = pos + 1
    else:
        q = _project_q(cfg, p, x, plain=plain)
        valid = cache_k.shape[2] if kv_len is None else kv_len
    q_t = q.transpose(1, 2).contiguous()
    out = ops.attention(q_t, cache_k.to(q_t.dtype), cache_v.to(q_t.dtype),
                        causal=False, kv_len=valid, plain=plain)
    out = out.transpose(1, 2).reshape(B, 1, cfg.q_dim)
    return out @ p["wo"].to(x.dtype), cache_k, cache_v


# ---------------------------------------------------------------- dense mlp

def init_mlp(cfg, gen: torch.Generator, device: torch.device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": _init(gen, (d, f), device),
                "w_up": _init(gen, (d, f), device),
                "w_down": _init(gen, (f, d), device, scale=1.0 / math.sqrt(f))}
    return {"w_up": _init(gen, (d, f), device),
            "w_down": _init(gen, (f, d), device, scale=1.0 / math.sqrt(f))}


def mlp_fwd(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    elif cfg.mlp_kind == "relu2":
        h = torch.square(torch.clamp_min(x @ p["w_up"].to(x.dtype), 0.0))
    else:  # gelu, the tanh form (jax.nn.gelu's default)
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    return h @ p["w_down"].to(x.dtype)
