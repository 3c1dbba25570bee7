"""SFU row kernels: DORA's special-function unit (paper §3.5) on the H100.

Replaces the Pallas TPU kernels of ``src/repro/kernels/sfu.py``
(``_softmax_kernel``, ``_layernorm_kernel``, ``_gelu_kernel``,
``_rmsnorm_kernel``) with the hand-written CUDA kernels of
``csrc/sfu.cu``: one block per row with warp-shuffle reductions over the
row's true width (softmax, layernorm); one element-wise kernel for the
runtime's GELU / ReLU / ReLU² / SiLU ops, on 16-byte float4 loads and
stores; and rmsnorm with one warp per row up to 1024 wide
(the decoder's q/k-norm rows of head_dim) and, for wider rows, a one-pass
kernel that holds two 16-byte vectors of the row in each thread's
registers (``rmsnorm_plan``).  Unaligned operands take scalar kernels of
the same file.  All are bound by device-memory bytes on the card.
softmax, layernorm and the activations take fp32, as the runtime's LMU
tiles are; rmsnorm takes fp32 or bf16 rows (the decoder's activations)
with an fp32 gamma.

A tensor on the CPU goes to the plain version in ``ref``; a CUDA tensor
goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import torch

from . import _build, ref
from .ref import ACTIVATIONS

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sfu_softmax_f32": (_P, _P, _I, _I, _P),
    "sfu_layernorm_f32": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _P),
    "sfu_act_f32": (_P, _P, ctypes.c_longlong, _I, _I, _P),
    "sfu_rmsnorm_f32": (_P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
    "sfu_rmsnorm_bf16": (_P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
}

WARP_ROW_MAX = 1024      # widest row of the warp-per-row rmsnorm kernel
ROW_VPT = 2              # 16-byte vectors a thread of the one-pass kernel
MAX_THREADS = 1024


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _aligned(*ts: torch.Tensor | None) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def rmsnorm_plan(N: int, esize: int, aligned: bool) -> int:
    """Threads a row of the one-pass kernel, or 0 for the scalar kernels.
    The one-pass kernel takes rows wider than ``WARP_ROW_MAX`` of a whole
    number of 16-byte vectors, with x, y and gamma 16-byte aligned:
    ``ROW_VPT`` vectors a thread, in whole warps of at most
    ``MAX_THREADS``.  Two vectors a thread cover every served width (2560
    to 6144, bf16 or fp32); wider rows take the scalar kernels."""
    if N <= WARP_ROW_MAX or not aligned or N * esize % 16:
        return 0
    threads = 32 * _cdiv(_cdiv(N * esize // 16, ROW_VPT), 32)
    return threads if threads <= MAX_THREADS else 0


def _on_card(x: torch.Tensor, what: str, *params: torch.Tensor | None
             ) -> bool:
    """Validate ``x`` and its per-column params; True when the call goes
    to the kernel, False when it goes to the CPU's plain version."""
    if x.dim() != 2:
        raise ValueError(f"{what} takes a 2-D (rows, cols) tensor, got "
                         f"{tuple(x.shape)}")
    for t in (x, *(p for p in params if p is not None)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    for p in params:
        if p is not None and tuple(p.shape) != (x.shape[1],):
            raise ValueError(f"{what}: gamma/beta must be ({x.shape[1]},)")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda (or cpu), not {x.device}")
    return True


def _lib() -> ctypes.CDLL:
    return _build.load("sfu", _SIGNATURES)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row softmax, max-subtracted, fp32."""
    if not _on_card(x, "softmax_rows"):
        return ref.softmax_rows(x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    R, N = x.shape
    with torch.cuda.device(x.device):
        err = _lib().sfu_softmax_f32(x.data_ptr(), out.data_ptr(), R, N,
                                     _stream(x))
    _build.check(err, "softmax_rows")
    softmax_rows.launches += 1
    return out


def layernorm_rows(x: torch.Tensor, gamma: torch.Tensor | None = None,
                   beta: torch.Tensor | None = None, eps: float = 1e-5
                   ) -> torch.Tensor:
    """Row layernorm with population variance; gamma and beta optional."""
    if not _on_card(x, "layernorm_rows", gamma, beta):
        return ref.layernorm_rows(x, gamma, beta, eps)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    R, N = x.shape
    with torch.cuda.device(x.device):
        err = _lib().sfu_layernorm_f32(
            x.data_ptr(), gamma.data_ptr() if gamma is not None else None,
            beta.data_ptr() if beta is not None else None, out.data_ptr(),
            R, N, eps, _stream(x))
    _build.check(err, "layernorm_rows")
    layernorm_rows.launches += 1
    return out


def act_rows(x: torch.Tensor, act: str) -> torch.Tensor:
    """Element-wise ``act`` (gelu in the tanh form, relu, relu2, silu)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if not _on_card(x, "act_rows"):
        return ref.ACT_FN[act](x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _launch_act(x, out, act, _aligned(x, out))
    act_rows.launches += 1
    return out


def _launch_act(x: torch.Tensor, out: torch.Tensor, act: str,
                vector: bool) -> None:
    """Runs the activation kernel on checked, non-empty CUDA operands: the
    float4 kernel (``vector``, x and out 16-byte aligned) or the scalar
    one."""
    with torch.cuda.device(x.device):
        err = _lib().sfu_act_f32(x.data_ptr(), out.data_ptr(), x.numel(),
                                 _build.ACT_CODE[act], int(vector),
                                 _stream(x))
    _build.check(err, "act_rows")


def rmsnorm_rows(x: torch.Tensor, gamma: torch.Tensor | None = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """Row rmsnorm, ``x * rsqrt(sum(x²)/N + eps) * gamma``: x fp32 or
    bf16, gamma fp32 (optional), fp32 arithmetic, output in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"rmsnorm_rows takes a 2-D (rows, cols) tensor, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm_rows takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm_rows: x must be contiguous")
    if gamma is not None:
        if gamma.dtype != torch.float32 or tuple(gamma.shape) != (x.shape[1],):
            raise ValueError(f"rmsnorm_rows: gamma must be float32 "
                             f"({x.shape[1]},), got {gamma.dtype} "
                             f"{tuple(gamma.shape)}")
        if gamma.device != x.device or not gamma.is_contiguous():
            raise ValueError("rmsnorm_rows: gamma must be contiguous, on "
                             "x's device")
    if x.device.type == "cpu":
        return ref.rmsnorm_rows(x, gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_rows runs on cuda (or cpu), not {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _launch_rmsnorm(x, gamma, eps, out,
                    rmsnorm_plan(x.shape[1], x.element_size(),
                                 _aligned(x, out, gamma)))
    rmsnorm_rows.launches += 1
    return out


def _launch_rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None, eps: float,
                    out: torch.Tensor, threads: int) -> None:
    """Runs the rmsnorm kernel on checked, non-empty CUDA operands: the
    one-pass kernel with ``threads`` threads a row, or the scalar kernels
    for 0 (see ``rmsnorm_plan``)."""
    R, N = x.shape
    fn = (_lib().sfu_rmsnorm_f32 if x.dtype == torch.float32
          else _lib().sfu_rmsnorm_bf16)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), gamma.data_ptr() if gamma is not None else None,
                 out.data_ptr(), R, N, eps, threads, _stream(x))
    _build.check(err, "rmsnorm_rows")


softmax_rows.launches = 0
layernorm_rows.launches = 0
act_rows.launches = 0
rmsnorm_rows.launches = 0
