"""Decoder-only language models on the port's kernels.

config  — ``ArchConfig`` / ``LayerPattern`` (a copy of the reference's)
layers  — norms, RoPE, GQA attention, dense MLP (``repro.models.layers``)
ssm     — the Mamba-2 block: init, prefill with its cache, decode
          (``repro.models.ssm``)
lm      — ``init``, ``forward``, ``init_cache``, ``prefill``,
          ``decode_step`` for the dense, SSM and hybrid patterns without
          MoE (``repro.models.lm``)
"""
