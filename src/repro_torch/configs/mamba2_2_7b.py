"""mamba2-2.7b [ssm] — attention-free SSD stack (no FFN).
[arXiv:2405.21060]"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280,
        norm_kind="rmsnorm",
        pattern=(LayerPattern("ssm", "none"),),
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    )


def reduced() -> ArchConfig:
    return config().reduced()
