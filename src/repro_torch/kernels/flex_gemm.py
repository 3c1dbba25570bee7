"""flex_gemm: DORA's dynamic-loop-bound MMU (paper §3.3) on the H100.

Replaces the Pallas TPU kernel ``_flex_gemm_kernel``
(``src/repro/kernels/flex_gemm.py``) with the hand-written CUDA kernel
``csrc/flex_gemm.cu``: ``C = epi(A @ B + c + bias)``, fp32 accumulation
(fp32 FMA, never TF32), output in A's dtype.  M, K and N are kernel
arguments, so one compiled program serves every shape; ragged edges are
masked in the kernel.  ``c`` is the accumulator input: the runtime passes
the LMU OUT tile when an ``MMU_GEMM`` has ``accumulate`` set, which keeps
the accumulate-then-epilogue order of ``runtime.py`` inside one kernel.

Bound on the card: fp32 FMA throughput for the paper workloads' tiles
(see the source note in ``csrc/flex_gemm.cu``).

A tensor on the CPU goes to the plain version ``ref.gemm``; a CUDA tensor
goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .ref import EPILOGUES

_DTYPES = (torch.float32, torch.bfloat16)
_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
_SIGNATURES = {"flex_gemm_f32": _ARGS, "flex_gemm_bf16": _ARGS}


def _check(a, b, bias, epilogue, c) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"flex_gemm needs A (M,K) and B (K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    M, N = a.shape[0], b.shape[1]
    operands = {"A": a, "B": b}
    if epilogue.startswith("bias"):
        if bias is None or tuple(bias.shape) != (N,):
            raise ValueError(f"epilogue {epilogue!r} needs bias of shape "
                             f"({N},)")
        operands["bias"] = bias
    if c is not None:
        if tuple(c.shape) != (M, N):
            raise ValueError(f"accumulator c must be ({M},{N}), got "
                             f"{tuple(c.shape)}")
        operands["c"] = c
    if a.dtype not in _DTYPES:
        raise TypeError(f"flex_gemm takes float32 or bfloat16, got {a.dtype}")
    for name, t in operands.items():
        if t.dtype != a.dtype:
            raise TypeError(f"{name} is {t.dtype}, A is {a.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, A is on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flex_gemm(a: torch.Tensor, b: torch.Tensor,
              bias: torch.Tensor | None = None, *, epilogue: str = "none",
              c: torch.Tensor | None = None) -> torch.Tensor:
    """``C[M,N] = epi(A[M,K] @ B[K,N] + c[M,N] + bias[N])``; ``bias`` is
    read only by the ``bias*`` epilogues, ``c`` is optional."""
    _check(a, b, bias, epilogue, c)
    if a.device.type == "cpu":
        return ref.gemm(a, b, bias, epilogue, c)
    if a.device.type != "cuda":
        raise ValueError(f"flex_gemm runs on cuda (or cpu), not {a.device}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = _build.load("flex_gemm", _SIGNATURES)
    fn = lib.flex_gemm_f32 if a.dtype == torch.float32 else lib.flex_gemm_bf16
    use_bias = epilogue.startswith("bias")
    act = _build.ACT_CODE.get(epilogue.split("_")[-1], 0)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 c.data_ptr() if c is not None else None,
                 bias.data_ptr() if use_bias else None,
                 out.data_ptr(), M, K, N, act,
                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "flex_gemm")
    flex_gemm.launches += 1
    return out


flex_gemm.launches = 0
