"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP. [arXiv:2402.16819]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=256000,
        mlp_kind="relu2", norm_kind="layernorm", rope_theta=1e4,
        pattern=(LayerPattern("attn", "dense"),),
        fsdp=True,
    )


def reduced() -> ArchConfig:
    return config().reduced()
