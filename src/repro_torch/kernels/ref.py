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
``mha_attention``).
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


def rmsnorm_rows(x: torch.Tensor, gamma: torch.Tensor | None = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * gamma`` in fp32, in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma.float()
    return y.to(x.dtype)


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
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    skv = k.shape[2] if kv_len is None else kv_len
    group = Hq // Hkv
    qf = q.float() * (1.0 / math.sqrt(D))
    kf = k[:, :, :skv].float().repeat_interleave(group, dim=1)
    vf = v[:, :, :skv].float().repeat_interleave(group, dim=1)
    s = qf @ kf.transpose(-1, -2)                       # (B, Hq, Sq, Skv)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (skv - Sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        mask = ki <= qi
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if skv else s.sum(-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)
