"""Decoder-only language models on the port's kernels.

config  — ``ArchConfig`` / ``LayerPattern`` (a copy of the reference's)
layers  — norms, RoPE, GQA attention, dense MLP (``repro.models.layers``)
lm      — ``init``, ``forward``, ``init_cache``, ``prefill``,
          ``decode_step`` for the dense archs (``repro.models.lm``)
"""
