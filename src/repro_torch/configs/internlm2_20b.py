"""internlm2-20b [dense] — GQA. [arXiv:2403.17297; hf]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92544,
        mlp_kind="swiglu", norm_kind="rmsnorm", rope_theta=1e6,
        pattern=(LayerPattern("attn", "dense"),),
        fsdp=True,
    )


def reduced() -> ArchConfig:
    return config().reduced()
