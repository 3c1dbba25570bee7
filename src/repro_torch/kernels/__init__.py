"""Hand-written CUDA kernels for Hopper (+ plain PyTorch versions in ref.py).

flex_gemm  — dynamic-loop-bound GEMM (the paper's MMU, §3.3)
sfu        — row softmax / layernorm and element-wise activations (§3.5)

Sources live in ``csrc/`` and are built by ``_build`` at first use.
"""

from . import ref
from .flex_gemm import flex_gemm
from .sfu import act_rows, layernorm_rows, softmax_rows
