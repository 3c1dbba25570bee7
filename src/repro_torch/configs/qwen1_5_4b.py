"""qwen1.5-4b [dense] — QKV bias, MHA (kv=20). [hf:Qwen/Qwen1.5-0.5B; hf]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
        d_ff=6912, vocab_size=151936,
        qkv_bias=True, mlp_kind="swiglu", norm_kind="rmsnorm",
        rope_theta=1e6,
        pattern=(LayerPattern("attn", "dense"),),
    )


def reduced() -> ArchConfig:
    return config().reduced()
