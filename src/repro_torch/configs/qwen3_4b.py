"""qwen3-4b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab_size=151936,
        qk_norm=True, mlp_kind="swiglu", norm_kind="rmsnorm",
        rope_theta=1e6,
        pattern=(LayerPattern("attn", "dense"),),
    )


def reduced() -> ArchConfig:
    return config().reduced()
