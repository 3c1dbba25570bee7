"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab_size=100352,
        mlp_kind="swiglu", norm_kind="layernorm", rope_theta=5e5,
        pattern=(LayerPattern("attn", "moe"),),
        n_experts=16, top_k=4,
        fsdp=True, moment_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return config().reduced()
