"""repro_torch: DORA (Dataflow-Instruction Orchestration Architecture)
on PyTorch and CUDA, for one NVIDIA H100.

The port of the JAX/Pallas package ``repro``, which stays beside it as
the reference.  It imports neither JAX nor ``repro``.

Subpackages:
  core     — the paper: ISA, two-stage DSE, schedulers, codegen,
             simulator, multi-tenant merging and interleaving, the
             multi-PE mesh, architecture search, the serving simulator
             and tuning (numpy copies of ``repro.core``) and the
             functional runtime, whose DRAM and LMU tiles are device
             tensors
  kernels  — hand-written CUDA kernels for Hopper (flex_gemm, the SFU and
             norm rows, flash_attention, ssd) and their plain PyTorch
             versions in ``kernels.ref``
  configs  — the paper's workload DAGs and the model configs
  models   — decoder-only LMs (``lm``, ``ssm``) and the encoder-decoder
             (``encdec``)
  launch   — the batched server
  convert  — numpy tensors and parameters of the reference onto the device
"""
