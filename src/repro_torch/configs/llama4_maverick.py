"""llama4-maverick-400b-a17b [moe] — 128e top-1 MoE on every 2nd layer
(dense interleave), early fusion. [hf:meta-llama/Llama-4-*; unverified]

24 MoE layers x 128 experts x swiglu(5120->8192) ~= 386B expert params;
total ~396B, active ~17B (top-1) — matches -400b-a17b.
"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        mlp_kind="swiglu", norm_kind="rmsnorm", rope_theta=5e5,
        pattern=(LayerPattern("attn", "dense"), LayerPattern("attn", "moe")),
        n_experts=128, top_k=1,
        fsdp=True, moment_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return config().reduced()
