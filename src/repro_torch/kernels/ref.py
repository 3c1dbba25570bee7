"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro.kernels.ref``.  Each function computes what its
hand-written CUDA kernel computes, in fp32, written out step by step:
the wrappers in ``flex_gemm.py`` / ``sfu.py`` use these for tensors on
the CPU, and the tests and ``chip_smoke.py`` hold the kernels against
them.  Nothing on the card's main path calls them.

Numerics follow the reference: GELU is the tanh form (``jax.nn.gelu``'s
default and ``NonLinear.GELU``), layernorm uses the population variance.
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
