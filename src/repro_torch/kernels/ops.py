"""The model code's kernel entry points.

Counterpart of the serving half of ``repro.kernels.ops``: ``rmsnorm``
and ``layernorm`` flatten the leading dims into rows for the row kernels
in x's own dtype (``src/repro/kernels/ops.py:95-103``), ``attention`` takes the
``(B, H, S, D)`` layout of the attention kernel, ``ssd`` the
``(B, S, H, P)`` layout of the SSM block, and ``ssd_decode_step`` is
the plain one-token update (no kernel in either package).  A CUDA tensor
goes to the kernel and a CPU tensor to its plain version, through the
wrappers.
``plain=True`` names the plain version on any device: ``chip_smoke.py``
uses it to run the same model on the card without the kernels.  It is an
argument, never a fallback.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention
from .sfu import layernorm_rows, rmsnorm_rows
from .ssd import ssd as ssd_kernel


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None = None,
            eps: float = 1e-6, *, plain: bool = False) -> torch.Tensor:
    """rmsnorm over the last dim; fp32 or bf16 x, fp32 gamma."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = ref.rmsnorm_rows(x2, gamma, eps) if plain \
        else rmsnorm_rows(x2, gamma, eps)
    return out.reshape(x.shape)


def layernorm(x: torch.Tensor, gamma: torch.Tensor | None = None,
              beta: torch.Tensor | None = None, eps: float = 1e-5, *,
              plain: bool = False) -> torch.Tensor:
    """layernorm over the last dim; fp32 or bf16 x, fp32 gamma and beta,
    fp32 arithmetic, output in x's dtype (one rounding, at the store)."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = ref.layernorm_rows(x2, gamma, beta, eps) if plain \
        else layernorm_rows(x2, gamma, beta, eps)
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


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = 128, initial_state: torch.Tensor | None = None,
        plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD over x (B, S, H, P), a (B, S, H), b/c (B, S, G, N) ->
    (y, final fp32 state (B, H, P, N)); see ``ref.ssd_scan``.  The
    reference's ``ops.ssd`` returns ``(y, None)`` on its kernel path; the
    kernel here writes the final state, so prefill takes it from there.
    ``plain`` chooses between the chunked algorithm and the recurrence as
    the reference does (``ref.ssd_plain``)."""
    if plain:
        return ref.ssd_plain(x, a, b, c, chunk=chunk,
                             initial_state=initial_state)
    return ssd_kernel(x, a, b, c, chunk=chunk, initial_state=initial_state)


def ssd_decode_step(x_t: torch.Tensor, a_t: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of SSD (plain PyTorch on every device, as the reference's
    ``ops.ssd_decode_step`` is plain jnp): x_t (B, H, P), a_t (B, H),
    b_t/c_t (B, G, N), state (B, H, P, N) -> (y_t, new state)."""
    return ref.ssd_decode_step(x_t, a_t, b_t, c_t, state)
