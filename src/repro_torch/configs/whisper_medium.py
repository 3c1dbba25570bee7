"""whisper-medium [audio] — enc-dec (24+24), conv frontend STUB.
[arXiv:2212.04356]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=51865,
        mlp_kind="gelu", norm_kind="layernorm",
        pattern=(LayerPattern("attn", "dense"),),
        encoder_layers=24, frontend="audio_stub",
    )


def reduced() -> ArchConfig:
    return config().reduced()
