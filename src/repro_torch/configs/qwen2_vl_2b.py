"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision frontend STUB:
input_specs supplies text tokens + 3-channel position ids).
[arXiv:2409.12191; hf]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936,
        qkv_bias=True, m_rope=True, m_rope_sections=(16, 24, 24),
        mlp_kind="swiglu", norm_kind="rmsnorm", rope_theta=1e6,
        pattern=(LayerPattern("attn", "dense"),),
        frontend="vision_stub",
    )


def reduced() -> ArchConfig:
    return config().reduced()
