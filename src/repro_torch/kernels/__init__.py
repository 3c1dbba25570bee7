"""Hand-written CUDA kernels for Hopper (+ plain PyTorch versions in ref.py).

flex_gemm        — dynamic-loop-bound GEMM (the paper's MMU, §3.3)
sfu              — row softmax / layernorm / rmsnorm and element-wise
                   activations (§3.5); rmsnorm's and layernorm's
                   backwards
flash_attention  — GQA attention with an online softmax (serving), and
                   its backward (training)
ssd              — the Mamba-2 chunked SSD scan (SSM prefill), and its
                   backward (training)
ops              — the model code's entry points (leading dims flattened)

Sources live in ``csrc/`` and are built by ``_build`` at first use.
"""

from . import ref
from .flex_gemm import flex_gemm
from .flash_attention import flash_attention, flash_attention_bwd
from .sfu import (act_rows, layernorm_bwd, layernorm_rows, rmsnorm_bwd,
                  rmsnorm_rows, softmax_rows)
from .ssd import ssd, ssd_bwd
