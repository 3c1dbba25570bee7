"""Model building blocks of the dense decoders: norms, RoPE, GQA
attention and the dense MLP.

Port of the dense parts of ``repro.models.layers``.  Parameters are plain
dicts of tensors with the reference's names and layouts: a weight is
``(in, out)`` and applied as ``x @ w``, cast to the activations' dtype
at use (``w.to(x.dtype)``, a no-op once ``lm.cast_params`` has cast it
at load).  Norm gains stay fp32, as in the reference.  The norms and
attention run on the port's kernels through ``kernels.ops``; ``plain``
selects their plain versions.  The matrix products stay ``torch.matmul``
as the reference leaves them to XLA.  Sharding specs wait for the
multi-device layer (ROADMAP A.6); MoE (``init_moe`` / ``moe_fwd``) and
M-RoPE wait for A.4.
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
    """x: (B, S, H, D); positions: (B, S).  Rotates the two halves of
    the head in fp32 (frequencies from numpy float64, cast to fp32) and
    casts back to x's dtype."""
    if positions.dim() != 2 or m_rope_sections is not None:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet: "
                                  "ROADMAP A.4")
    D = x.shape[-1]
    freqs = _device_freqs(D, theta, x.device)
    ang = positions.float()[:, :, None] * freqs[None, None]     # (B,S,D/2)
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


def _project_qkv(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 *, plain: bool = False):
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p["q_norm"], plain=plain)
        k = ops.rmsnorm(k, p["k_norm"], plain=plain)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_fwd(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  *, causal: bool = True, plain: bool = False):
    """Full-sequence self-attention (prefill).  Returns (out, (k, v)) with
    k/v in the cache's (B, Hkv, S, D) layout."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, plain=plain)
    q_t = q.transpose(1, 2).contiguous()
    k_t = k.transpose(1, 2).contiguous()
    v_t = v.transpose(1, 2).contiguous()
    out = ops.attention(q_t, k_t, v_t, causal=causal, plain=plain)
    out = out.transpose(1, 2).reshape(B, S, cfg.q_dim)
    return out @ p["wo"].to(x.dtype), (k_t, v_t)


def attention_decode(cfg, p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, *,
                     plain: bool = False):
    """Single-token self-attention.  x: (B, 1, D); cache_k/v:
    (B, Hkv, Smax, D); pos: tokens already in the cache.  Writes this
    token's k/v into row ``pos`` of the caches in place (the reference's
    ``dynamic_update_slice`` returns new arrays) and attends over rows
    ``[0, pos]``.  Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, plain=plain)
    cache_k[:, :, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, pos] = v[:, 0].to(cache_v.dtype)
    q_t = q.transpose(1, 2).contiguous()
    out = ops.attention(q_t, cache_k.to(q_t.dtype), cache_v.to(q_t.dtype),
                        causal=False, kv_len=pos + 1, plain=plain)
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
