"""The model code's kernel entry points.

Counterpart of the serving half of ``repro.kernels.ops``: ``rmsnorm``
flattens the leading dims into rows for the row kernel
(``src/repro/kernels/ops.py:95-103``) and ``attention`` takes the
``(B, H, S, D)`` layout of the attention kernel.  A CUDA tensor goes to
the kernel and a CPU tensor to its plain version, through the wrappers.
``plain=True`` names the plain version on any device: ``chip_smoke.py``
uses it to run the same model on the card without the kernels.  It is an
argument, never a fallback.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention
from .sfu import rmsnorm_rows


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None = None,
            eps: float = 1e-6, *, plain: bool = False) -> torch.Tensor:
    """rmsnorm over the last dim; fp32 or bf16 x, fp32 gamma."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = ref.rmsnorm_rows(x2, gamma, eps) if plain \
        else rmsnorm_rows(x2, gamma, eps)
    return out.reshape(x.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len: int | None = None,
              plain: bool = False) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, D), k/v (B, Hkv, S, D), over the first
    ``kv_len`` KV rows.  ``kv_len`` is one length for the whole batch,
    as decode's ``pos + 1`` is (``repro``'s ``ops.attention`` takes a
    (B,) array and sends it to the oracle)."""
    if plain:
        return ref.mha_attention(q, k, v, causal=causal, kv_len=kv_len)
    return flash_attention(q, k, v, causal=causal, kv_len=kv_len)
