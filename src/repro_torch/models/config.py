"""Architecture configuration: one dataclass drives every assigned arch.

A model is ``n_layers`` layers following a repeating *block pattern* of
length ``pattern_len`` (1 for uniform stacks). Each pattern position
declares its sequence mixer ("attn" | "ssm") and its FFN ("dense" |
"moe"), which lets jamba's 1:7 Mamba:attention interleave and the
every-2nd-layer MoE of llama4/jamba scan over homogeneous super-blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class LayerPattern:
    mixer: str = "attn"       # "attn" | "ssm"
    ffn: str = "dense"        # "dense" | "moe"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    m_rope: bool = False                      # qwen2-vl 3-section M-RoPE
    m_rope_sections: tuple[int, ...] = (16, 24, 24)   # head_dim/2 split

    # mlp
    mlp_kind: str = "swiglu"  # swiglu | gelu | relu2
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm

    # block pattern (repeats n_layers // pattern_len times)
    pattern: tuple[LayerPattern, ...] = (LayerPattern(),)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv_width: int = 4

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    causal_encoder: bool = False

    # frontend stubs ([audio]/[vlm]: precomputed embeddings)
    frontend: str = "none"    # none | audio_stub | vision_stub

    # numerics / memory
    scan_unroll: bool = False   # unroll layer scans (dry-run cost probes)
    remat_policy: str = "nothing"   # nothing | dots | dots_nb
    microbatch: int = 1         # gradient-accumulation microbatches
    attn_chunk_threshold: int = 8192  # use online-softmax chunked
                                      # attention at/after this seq len
    kv_cache_repeat: int = 1    # replicate KV heads in the decode cache
                                # so kv_heads*repeat divides the model
                                # axis: trades cache bytes for a local
                                # (no-reshard) cache update
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"   # bf16 for the >=100B configs
    remat: bool = True

    # distribution knobs (consumed by repro.parallel.sharding)
    fsdp: bool = False        # shard "embed"-like param dims over data
    tp_attention: bool = True
    seq_parallel: bool = False  # sequence-parallel TP: shard the token
                                # dim over "model" between blocks so TP
                                # all-reduces become reduce-scatter +
                                # all-gather (Korthikanti et al.)

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, len(self.pattern))

    # ------------------------------------------------------------ derived
    @property
    def pattern_len(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        return self.n_layers // self.pattern_len

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_attention(self) -> bool:
        return any(p.mixer == "attn" for p in self.pattern)

    @property
    def attention_free_or_hybrid(self) -> bool:
        """True if long-context decode is sub-quadratic-friendly (pure
        SSM or hybrid with a small attention fraction)."""
        mixers = [p.mixer for p in self.pattern]
        return "ssm" in mixers

    def param_count(self) -> int:
        """Total parameters (embeddings + blocks + head)."""
        d, V = self.d_model, self.vocab_size
        total = V * d              # token embedding
        total += V * d             # lm head (untied)
        total += d                 # final norm
        for p in self.pattern:
            per = 2 * d            # two norms
            if p.mixer == "attn":
                per += d * self.q_dim + 2 * d * self.kv_dim \
                    + self.q_dim * d
                if self.qkv_bias:
                    per += self.q_dim + 2 * self.kv_dim
                if self.qk_norm:
                    per += 2 * self.head_dim
            else:
                din = self.ssm_inner
                nh, ns = self.ssm_heads, self.ssm_state
                proj_in = 2 * din + 2 * self.ssm_groups * ns + nh
                per += d * proj_in                 # in_proj
                per += self.ssm_conv_width * (din + 2 * self.ssm_groups * ns)
                per += nh * 3                      # A_log, D, dt_bias
                per += din * d                     # out_proj
            if p.ffn == "moe":
                per += d * self.n_experts          # router
                mults = 3 if self.mlp_kind == "swiglu" else 2
                per += self.n_experts * mults * d * self.d_ff
            else:
                mults = 3 if self.mlp_kind == "swiglu" else 2
                per += mults * d * self.d_ff
            total += per * self.n_blocks
        if self.is_encdec:
            # encoder blocks (attn + dense ffn) + cross-attn in decoder
            mults = 3 if self.mlp_kind == "swiglu" else 2
            enc_per = (d * self.q_dim + 2 * d * self.kv_dim
                       + self.q_dim * d + mults * d * self.d_ff + 3 * d)
            total += enc_per * self.encoder_layers
            cross_per = (d * self.q_dim + 2 * d * self.kv_dim
                         + self.q_dim * d + d)
            total += cross_per * self.n_layers
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        mults = 3 if self.mlp_kind == "swiglu" else 2
        expert_p = mults * d * self.d_ff
        n_moe_layers = sum(1 for p in self.pattern if p.ffn == "moe") \
            * self.n_blocks
        dead = (self.n_experts - self.top_k) * expert_p * n_moe_layers
        return self.param_count() - dead

    def reduced(self, n_layers: int | None = None) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        pat = self.pattern
        nl = n_layers or max(2 * len(pat), len(pat))
        nl = -(-nl // len(pat)) * len(pat)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        while kv > 1 and heads % kv:
            kv -= 1
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=nl,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16 if self.head_dim else 0,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            m_rope_sections=(2, 3, 3) if self.m_rope else self.m_rope_sections,
            encoder_layers=min(self.encoder_layers, 2),
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            fsdp=False,
        )
