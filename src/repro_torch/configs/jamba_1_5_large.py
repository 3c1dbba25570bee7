"""jamba-1.5-large-398b [hybrid] — Mamba:attention 7:1 interleave,
MoE 16e top-2 on every 2nd layer. [arXiv:2403.19887; hf]

Pattern (8 layers / super-block, 9 blocks = 72 layers):
  pos0 attn+dense, pos1 ssm+moe, pos2 ssm+dense, pos3 ssm+moe,
  pos4 ssm+dense, pos5 ssm+moe, pos6 ssm+dense, pos7 ssm+moe
-> 36 MoE layers x 16 experts x swiglu(8192->24576) ~= 348B expert
params; total ~398B (matches the name).
"""
from ..models.config import ArchConfig, LayerPattern


def config() -> ArchConfig:
    pat = [LayerPattern("attn", "dense")]
    for i in range(1, 8):
        pat.append(LayerPattern("ssm", "moe" if i % 2 == 1 else "dense"))
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=65536,
        mlp_kind="swiglu", norm_kind="rmsnorm", rope_theta=1e6,
        pattern=tuple(pat),
        n_experts=16, top_k=2,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        fsdp=True, moment_dtype="bfloat16",
    )


def reduced() -> ArchConfig:
    return config().reduced()
