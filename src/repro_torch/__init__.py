"""repro_torch: DORA (Dataflow-Instruction Orchestration Architecture)
on PyTorch and CUDA, for one NVIDIA H100.

The port of the JAX/Pallas package ``repro``, which stays beside it as
the reference.  It imports neither JAX nor ``repro``.

Subpackages:
  core     — the paper: ISA, two-stage DSE, schedulers, codegen,
             simulator (numpy copies of ``repro.core``) and the functional
             runtime, whose DRAM and LMU tiles are device tensors
  kernels  — hand-written CUDA kernels for Hopper (flex_gemm, SFU rows)
             and their plain PyTorch versions in ``kernels.ref``
  configs  — the paper's workload DAGs
  convert  — numpy tensors of the reference onto the device
"""
